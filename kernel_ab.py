#!/usr/bin/env python3
"""Redesigned kernels against another tree's, on one card.

    python3 kernel_ab.py BASE_TREE [FAMILY ...]

BASE_TREE is another checkout of the repository (for instance `git archive`
of an earlier commit unpacked under `tpu_splat_torch/_build/`, which git
ignores). FAMILY is any of `fwd`, `rows`, `bwd`, `cube` (default: `fwd
rows`). The script builds, one `nvcc` each and all at once, the base
tree's source of each family asked for, this tree's, and their variants:

- `fwd:` tile_blend_forward (`tile_blend_fwd.cu`). `fwd:base_no_accept`:
  the base kernel with its accept branch cut (no pixel is ever done, so it
  walks every instance; timed only); `fwd:base_no_accept_no_exp`: the same
  with the expf of alpha replaced by the exponent plus a constant (timed
  only): what that expf costs a lane-iteration; `fwd:base_fast_exp`: the
  base kernel with that expf as the hardware `__expf` (same work, other last
  bits; timed only). This kernel's ablations: `fwd:no_cull`
  (`-DFWD_CULL=0`), `fwd:no_pairs` (its pair loop's body cut, so every
  chunk is derived and culled; timed only), `fwd:no_warp_exit`
  (`-DFWD_WARP_EXIT=0`),
  `fwd:min2`, `fwd:min3` (two or three blocks an SM as the launch bound;
  4 by default), `fwd:warps16x2`, `fwd:warps4x8` (each warp on two pixel
  rows or a 4x8 block, `-DFWD_WARP_COLS`; 8x4 blocks by default);
  `fwd:profile`, `fwd:profile16x2` (`-DFWD_PROFILE=1`: SM cycles each warp
  spends deriving, in its pair loops and at chunk ends, and its pair
  iterations, read after one launch), `fwd:profile_no_cull` (the same
  without the cull: the pair iterations the cull saves; chip_smoke.py
  phase 11 builds it).
- `rows:` segment_sum_rows (`segment_sum_rows.cu`). `rows:copy_only`: this
  kernel copying its spans but summing one row a run, and `rows:sum_only`:
  summing without copying (wrong sums, timed only); `rows:min4`: four
  blocks an SM as the launch bound (`-DSEGROWS_MIN_BLOCKS`; 6 by default);
  `rows:runs32`: 32 runs a block (`-DSEGROWS_RUNS`; 64 by default), also
  with a 4096-float buffer (`-DSEGROWS_BUF`; 8192 by default) at eight
  blocks an SM.
- `bwd:` tile_blend_backward and `cube:` cubemap_tap_accumulate, with the
  probes and builds that timed their redesign (`bwd:base_one_shuffle`
  patches the backward from before it, so its base tree is that one):
  `bwd:base_one_shuffle`, `bwd:sub32`,
  `bwd:sub128`, `bwd:min1`, `bwd:min2`, `bwd:sub32_min4`, `cube:warp_only`,
  `cube:warp_only_no_atomics`, `cube:direct`, `cube:table_no_grouping`,
  `cube:table1024`, `cube:threads256`, `cube:threads1024`.

Inputs. `fwd`: the bench frame's tile-kernel inputs as the served path
builds them (chip_smoke.py `captured_kernel_inputs`: 1M Gaussians,
1088x1920, view 0; the production switches' bf16-packed slab, and the
full-shape switches' float32 slab for the unpacked variants). `rows`: the
regroup rows of one warm-up tight training step (chip_smoke.py phase 7d),
made row-major. `bwd` / `cube`: the inputs one warm-up training step of the
bench load hands those kernels (chip_smoke.py phase 6c).

Checks. Every `fwd:` build that is not a probe must give out_px and wmax
equal bit for bit to the base tree's kernel in all eight train_shape x
packed_feats x collect_wmax variants; every `rows:` build must give sums
equal bit for bit to the base tree's kernel and within SEGSUM_TOL of the
plain version; `bwd:` and `cube:` builds whose sums stay right are held
against the plain versions (BWD_TOL on 64 sampled tiles, CUBEMAP_TOL). A
failed check raises.

Timing: CUDA events, every variant of a family in the order base, this,
variants, then back, ROUNDS times (median of the rounds); the forward both
as served (train_shape, packed, no wmax) and as the training step calls it
(wmax on). Counts: for the forward, from a transcription of its chunk loop
on the served inputs: the lane-iterations the first design issues (256 x
the instances a tile walks before its block leaves), the live alpha tests
among them, the warp-iterations in which no lane passes the alpha test, in
which all 32 pixels are done, and in which some live lane's exponent
reaches E_REJECT = log(1/255) - 2^-10; the (instance, warp) pairs in which
some pixel of the warp does (what an exact cull must keep) for warps on
16x2, 8x4 and 4x8 pixels, and how far the slowest warp of a chunk is above
the mean; each build's SASS (cuobjdump): the instructions of the
smallest loop around the alpha expf (the pair loop, statically); for this
tree's builds, the blocks that fit on an SM, and the profile builds'
counters. For the
backward, the (instance, warp) pairs holding a contributor; for the cubemap
kernel, how the taps fall on texels and one `index_add_` of the weighted
taps. It prints each result, the registers and spills `ptxas` reports, the
card's name and power limit, and writes everything to
chiprun_out/kernel_ab.json.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 5
REPS = 5
FAMILIES = ("fwd", "rows", "bwd", "cube")
DEFAULT_FAMILIES = ("fwd", "rows")
SOURCES = {"fwd": "tile_blend_fwd", "rows": "segment_sum_rows", "bwd": "tile_blend_bwd",
           "cube": "cubemap_accum"}

# variant name -> (the tree it comes from, extra nvcc flags, the patch
# applied to its text or None); the family is the name's prefix
VARIANTS = {
    "fwd:base": ("base", (), None),
    "fwd:base_no_accept": ("base", (), "no_accept"),
    "fwd:base_no_accept_no_exp": ("base", (), "no_accept_no_exp"),
    "fwd:base_fast_exp": ("base", (), "fast_exp"),
    "fwd:this": ("this", (), None),
    "fwd:no_cull": ("this", ("-DFWD_CULL=0",), None),
    "fwd:no_pairs": ("this", (), "no_pairs"),
    "fwd:no_warp_exit": ("this", ("-DFWD_WARP_EXIT=0",), None),
    "fwd:min2": ("this", ("-DFWD_MIN_BLOCKS=2",), None),
    "fwd:min3": ("this", ("-DFWD_MIN_BLOCKS=3",), None),
    "fwd:warps16x2": ("this", ("-DFWD_WARP_COLS=16",), None),
    "fwd:warps4x8": ("this", ("-DFWD_WARP_COLS=4",), None),
    "fwd:profile": ("this", ("-DFWD_PROFILE=1",), None),
    "fwd:profile16x2": ("this", ("-DFWD_PROFILE=1", "-DFWD_WARP_COLS=16"), None),
    "fwd:profile_no_cull": ("this", ("-DFWD_PROFILE=1", "-DFWD_CULL=0"), None),
    "rows:base": ("base", (), None),
    "rows:this": ("this", (), None),
    "rows:copy_only": ("this", (), "rows_copy_only"),
    "rows:sum_only": ("this", (), "rows_sum_only"),
    "rows:min4": ("this", ("-DSEGROWS_MIN_BLOCKS=4",), None),
    "rows:runs32": ("this", ("-DSEGROWS_RUNS=32",), None),
    "rows:runs32_buf4096_min8": ("this", ("-DSEGROWS_RUNS=32", "-DSEGROWS_BUF=4096",
                                          "-DSEGROWS_MIN_BLOCKS=8"), None),
    "bwd:base": ("base", (), None),
    "bwd:base_one_shuffle": ("base", (), "one_shuffle"),
    "bwd:this": ("this", (), None),
    "bwd:sub32": ("this", ("-DBWD_SUB=32",), None),
    "bwd:sub128": ("this", ("-DBWD_SUB=128",), None),
    "bwd:min1": ("this", ("-DBWD_MIN_BLOCKS=1",), None),
    "bwd:min2": ("this", ("-DBWD_MIN_BLOCKS=2",), None),
    "bwd:sub32_min4": ("this", ("-DBWD_SUB=32", "-DBWD_MIN_BLOCKS=4"), None),
    "cube:base": ("base", (), None),
    "cube:this": ("this", (), None),
    "cube:warp_only": ("this", ("-DCUBEMAP_TABLE=0",), None),
    "cube:warp_only_no_atomics": ("this", ("-DCUBEMAP_TABLE=0",), "no_atomics"),
    "cube:direct": ("this", ("-DCUBEMAP_TABLE=0",), "no_grouping"),
    "cube:table_no_grouping": ("this", (), "no_grouping"),
    "cube:table1024": ("this", ("-DCUBEMAP_TABLE=1024",), None),
    "cube:threads256": ("this", ("-DCUBEMAP_THREADS=256",), None),
    "cube:threads1024": ("this", ("-DCUBEMAP_THREADS=1024",), None),
}
_ALPHA = "const float alpha = expf(fminf(LOG_AMAX, fmaxf(s3, s2)));"
_ACCEPT = "if (depth >= NEAR_N && alpha >= ALPHA_MIN) {"
_NO_ACCEPT = "if (depth >= NEAR_N && alpha >= ALPHA_MIN && alpha == 1.2345e-30f) {"
# patch name -> ([(text, its replacement), ...], whether the result is still right)
PATCHES = {
    # the forward's accept branch cut (alpha kept live by the comparison)
    "no_accept": ([(_ACCEPT, _NO_ACCEPT)], False),
    # ... and its alpha from the exponent plus a constant, no expf
    "no_accept_no_exp": ([(_ACCEPT, _NO_ACCEPT),
                          (_ALPHA, "const float alpha = fminf(LOG_AMAX, fmaxf(s3, s2)) + 1.0f;")],
                         False),
    # this forward without its pair loop's body (no pixel is ever done, so
    # every chunk is derived and culled): what the rest costs
    "no_pairs": ([("          if (!done) {", "          if (!done && i < 0) {")], False),
    # the forward's alpha through the hardware exp (same work, other bits)
    "fast_exp": ([(_ALPHA, "const float alpha = __expf(fminf(LOG_AMAX, fmaxf(s3, s2)));")],
                 False),
    # the rows kernel's copy alone (one row of each run summed) and its sums
    # alone (nothing copied)
    "rows_copy_only": ([("#pragma unroll 4\n        for (int u = 0; u < len; ++u) a += p[u * n_feat];",
                         "        if (len > 0) a += p[0];")], False),
    "rows_sum_only": ([("        cp_async16(&s_buf[qi * 4], rows + g, left >= 4 ? 16 : (int)left * 4);",
                        "        if (left < 0) cp_async16(&s_buf[qi * 4], rows + g, 16);")], False),
    # the base backward's per-instance reduction cut to one shuffle
    "one_shuffle": ([("""        if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
          for (int k = 0; k < NSUM; ++k) v[k] = warp_sum(v[k]);
        }""", """        if (__any_sync(0xffffffffu, contrib)) {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
        }""")], False),
    # the cubemap kernel without its atomics (the sums kept live)
    "no_atomics": ([("  if (live && rank == 0) texel_add<C>(s_key, s_val, out, key, v);",
                     "  if (live && rank == 0 && v[0] == 1.2345e-30f)\n"
                     "    texel_add<C>(s_key, s_val, out, key, v);")], False),
    # every lane a group of its own: no warp grouping
    "no_grouping": ([("  const unsigned peers = __match_any_sync(FULL, key);",
                      "  const unsigned peers = 1u << lane;")], True),
}
# the forward's served call and the training step's
FWD_CALLS = {"served": dict(train_shape=True, packed_feats=True, collect_wmax=False),
             "train": dict(train_shape=True, packed_feats=True, collect_wmax=True)}
# the new forward's reject bound on the exponent: log(1/255) - 2^-10
E_REJECT = math.log(1 / 255) - 2.0 ** -10


def family(name: str) -> str:
    return name.split(":")[0]


def build_variants(base: str, out_dir: str, names) -> dict:
    """Compile the named variants at once; -> name -> {path, ptxas, seconds}."""
    from tpu_splat_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        tree, flags, patch = VARIANTS[name]
        src = SOURCES[family(name)]
        root = build.PKG_DIR if tree == "this" else os.path.join(base, "tpu_splat_torch")
        path = os.path.join(root, "csrc", f"{src}.cu")
        if patch is not None:
            text = open(path).read()
            for old, new in PATCHES[patch][0]:
                if old not in text:
                    raise RuntimeError(f"{name}: the text to replace is not in {path}")
                text = text.replace(old, new)
            path = os.path.join(out_dir, f"{src}_{tree}_{patch}.cu")
            with open(path, "w") as f:
                f.write(text)
        lib = os.path.join(out_dir, "lib" + re.sub(r"\W", "_", name) + ".so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, time.perf_counter())
    out = {}
    for name, (proc, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = dict(path=lib, seconds=time.perf_counter() - t0,
                         ptxas=[ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln])
    return out


def is_right(name: str) -> bool:
    patch = VARIANTS[name][2]
    return patch is None or PATCHES[patch][1]


def sass_loop(lib_path: str, instantiation: str, dump: str | None = None) -> dict | None:
    """Static SASS of one kernel instantiation (a substring of its mangled
    name): its instruction count, and the smallest loop (a backward branch
    and its target) around an `MUFU.EX2` -- the forward's pair loop -- with
    the instructions in it by kind; `dump` names a file for the function's
    text. None when cuobjdump is missing."""
    from tpu_splat_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if instantiation in f.split("\n", 1)[0]), None)
    if body is None:
        return None
    if dump is not None:
        with open(dump, "w") as f:
            f.write(body)
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body):
        words = m.group(2).split()
        op = words[1] if words and words[0].startswith("@") else (words[0] if words else "")
        ins.append((int(m.group(1), 16), op, m.group(2)))
    loops = []
    for addr, op, txt in ins:
        tgt = re.findall(r"0x([0-9a-f]+)", txt)
        if op.startswith("BRA") and tgt and int(tgt[-1], 16) <= addr:
            loops.append((int(tgt[-1], 16), addr))
    ex2 = [a for a, op, _ in ins if op.startswith("MUFU.EX2")]
    inner = [lp for lp in loops if any(lp[0] <= a <= lp[1] for a in ex2)]
    res = dict(instructions=len(ins), loops=len(loops))
    if inner:
        lo, hi = min(inner, key=lambda lp: lp[1] - lp[0])
        ops = [op for a, op, _ in ins if lo <= a <= hi]
        kinds = {}
        for k in ("MUFU.EX2", "MUFU.RCP", "MUFU.LG2", "SHFL", "VOTE", "REDUX", "LDS", "BAR",
                  "FFMA", "FMUL", "FADD", "FSETP", "BRA"):
            kinds[k] = sum(1 for op in ops if op.startswith(k))
        res.update(pair_loop_instructions=len(ops), pair_loop_kinds=kinds)
    return res


class Using:
    """Serve `csrc/<src>.cu`'s wrapper calls from another library."""

    def __init__(self, src: str, lib: ctypes.CDLL):
        self.src, self.lib = src, lib

    def __enter__(self):
        from tpu_splat_torch.kernels import build

        self.prev = build._LIBS.get(self.src)
        build._LIBS[self.src] = self.lib

    def __exit__(self, *exc):
        from tpu_splat_torch.kernels import build

        if self.prev is None:
            build._LIBS.pop(self.src, None)
        else:
            build._LIBS[self.src] = self.prev


def in_turns(calls: dict) -> dict:
    """Time each call (name -> fn) with CUDA events, in order and back,
    ROUNDS times -> name -> {median_ms, ms}."""
    import chip_smoke as cs

    order = list(calls)
    times = {name: [] for name in order}
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(cs.cuda_ms(calls[name], REPS))
    return {name: dict(median_ms=float(np.median(t)), ms=t) for name, t in times.items()}


# ---------------------------------------------------------------------------
# fwd: tile_blend_forward


def fwd_launch(lib: ctypes.CDLL, feats, index, **kw):
    """One call of the forward wrapper served by `lib`'s kernel."""
    from tpu_splat_torch.kernels import tile_blend as tb

    with Using("tile_blend_fwd", lib):
        return tb.tile_blend_forward(feats, *index, **kw)


def forward_counts(feats, starts, counts, org_x, org_y) -> dict:
    """What the forward's chunk loop does on these inputs (a transcription
    of the plain version's, tiles in batches): lane- and warp-iterations the
    first design issues (every lane of a block for each instance its tile
    walks before all 256 pixels are done), the live alpha tests among them
    (pixels not yet done), the warp-iterations in which no lane passes the
    alpha test, in which all 32 pixels are done, and in which some live
    lane's exponent reaches E_REJECT (in float32 as the plain version rounds
    it); the (instance, warp) pairs of warps not all done in which some
    pixel's does, for warps on 16x2, 8x4 and 4x8 pixels; the slowest warp's
    full tests and accepts per chunk against the mean; accepted and
    contributing pairs."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    dev, n_cap = feats.device, feats.shape[1]
    px, py, r2 = tb._pixel_basis(dev)
    ci_ar = torch.arange(tb.CI, device=dev)
    z = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    c = {k: z() for k in ("lane_iterations", "live_tests", "warp_iterations",
                          "warp_iterations_no_pass", "warp_iterations_all_done",
                          "warp_iterations_full_test", "lanes_full_test", "accepted",
                          "contributing", "full_test_sum_of_max", "full_test_sum_of_mean_x8",
                          "accept_sum_of_max", "accept_sum_of_mean_x8")}
    pix = torch.arange(tb.L, device=dev)
    layouts = {}  # pixel order that makes each 32 consecutive a warp
    for name, (bw, bh) in {"16x2": (16, 2), "8x4": (8, 4), "4x8": (4, 8)}.items():
        w_of = (pix // 16 // bh) * (16 // bw) + (pix % 16) // bw
        layouts[name] = torch.argsort(w_of * tb.L + pix)
        c[f"reach_{name}"] = z()
        c[f"reach_{name}_sum_of_max"] = z()
    order = torch.argsort(counts.long(), descending=True)
    for b0 in range(0, starts.shape[0], tb.PLAIN_TILE_BATCH):
        sel = order[b0:b0 + tb.PLAIN_TILE_BATCH]
        start, count = starts[sel], counts[sel]
        B = sel.shape[0]
        cxf = (org_x[sel] + 7).float()[:, None]
        cyf = (org_y[sel] + 7).float()[:, None]
        T_c = torch.ones((B, tb.L), device=dev)
        done = torch.zeros((B, tb.L), dtype=torch.bool, device=dev)
        for ci in range(int((int(count.max()) + tb.CI - 1) // tb.CI)):
            slot = ci * tb.CI + ci_ar
            idx = start[:, None].long() + slot
            valid = slot[None, :] < count[:, None]
            walking = (ci * tb.CI < count) & ~done.all(1)  # [B]: the block is still in
            n_walk = (valid.sum(1) * walking).sum()
            c["lane_iterations"] += tb.L * n_walk
            c["warp_iterations"] += (tb.L // 32) * n_walk
            wdone = done.reshape(B, -1, 32).all(-1)  # [B, 8]
            c["warp_iterations_all_done"] += (valid.sum(1) * walking * wdone.sum(1)).sum()
            fb = torch.where(valid[None], feats[:, torch.clamp(idx, 0, n_cap - 1)], 0.0)
            A, Bc, cp, da, db, dcc, sx, sy, s0, lo = tb._instance_coeffs(fb, cxf, cyf)
            field = lambda xc, yc, cc: xc[..., None] * px + yc[..., None] * py + cc[..., None]
            p0, p1, p2 = (field(A[k], Bc[k], cp[k]) for k in range(3))
            s2 = field(sx, sy, s0) - 0.5 * tb.FILTER_INV_SQUARE * r2
            unstable = p2.abs() < 1e-4
            ivp = 1.0 / torch.where(unstable, 1.0, p2)
            s3 = torch.where(unstable, -1e8, lo[..., None] - 0.5 * (p0 * p0 + p1 * p1) * ivp * ivp)
            s = torch.maximum(s3, s2)
            alpha = torch.exp(torch.clamp(s, max=tb.LOG_AMAX))
            depth = torch.where(unstable, fb[tb.F_TW + 2][..., None].expand_as(p2),
                                field(da, db, dcc) * ivp)
            del p0, p1, p2, s2, s3, ivp
            live = valid[..., None] & ~done[:, None] & walking[:, None, None]
            c["live_tests"] += live.sum()
            accept = live & (depth >= tb.NEAR_N) & (alpha >= tb.ALPHA_MIN)
            full = live & (s >= E_REJECT)
            # (instance, warp) pairs of warps not all done in which some
            # pixel, done or not, reaches E_REJECT -- what an exact cull must
            # keep -- for warps on 16x2, 8x4 and 4x8 pixels, and the slowest
            # of a chunk's 8 warps against their mean
            for name, perm in layouts.items():
                e_ok = (s >= E_REJECT)[..., perm].reshape(B, tb.CI, -1, 32).any(-1)
                d_w = done[:, perm].reshape(B, -1, 32).all(-1)
                kept = valid[..., None] & walking[:, None, None] & ~d_w[:, None, :] & e_ok
                c[f"reach_{name}"] += kept.sum()
                c[f"reach_{name}_sum_of_max"] += kept.sum(1).amax(1).sum()
            walked = valid & walking[:, None]  # [B, CI]
            per_warp = lambda m: m.reshape(B, tb.CI, -1, 32).any(-1)  # [B, CI, 8]
            c["warp_iterations_no_pass"] += (walked[..., None] & ~per_warp(accept)).sum()
            c["warp_iterations_full_test"] += per_warp(full).sum()
            # per (tile, chunk): the slowest warp's full-test iterations
            # against the mean of the block's 8 warps (the barrier waits on it)
            ft = per_warp(full).sum(1)  # [B, 8]
            c["full_test_sum_of_max"] += ft.amax(1).sum()
            c["full_test_sum_of_mean_x8"] += ft.sum()
            ac = per_warp(live & (depth >= tb.NEAR_N) & (alpha >= tb.ALPHA_MIN)).sum(1)
            c["accept_sum_of_max"] += ac.amax(1).sum()
            c["accept_sum_of_mean_x8"] += ac.sum()
            c["lanes_full_test"] += full.sum()
            c["accepted"] += accept.sum()
            a_eff = torch.where(accept, alpha, 0.0)
            u = torch.log1p(-a_eff)
            T_before = T_c[:, None] * torch.exp(tb._excl_cumsum(u, 1))
            contrib = accept & (T_before * (1.0 - a_eff) >= tb.T_EPS)
            c["contributing"] += contrib.sum()
            T_all = T_c * torch.exp(u.sum(1))
            T_c = T_c * torch.exp(torch.where(contrib, u, 0.0).sum(1))
            done = done | (T_all < tb.T_EPS)
            del alpha, depth, s, a_eff, u, T_before
            if bool(done.all()):
                break
    out = {k: int(v) for k, v in c.items()}
    out["instances"] = int(counts.long().sum())
    out["lane_iterations_no_termination"] = tb.L * out["instances"]
    out["live_share"] = out["live_tests"] / max(out["lane_iterations"], 1)
    for k in ("no_pass", "all_done", "full_test"):
        out[f"share_{k}"] = out[f"warp_iterations_{k}"] / max(out["warp_iterations"], 1)
    for k in ("full_test", "accept"):
        out[f"{k}_max_over_mean"] = 8 * out[f"{k}_sum_of_max"] / max(out[f"{k}_sum_of_mean_x8"], 1)
    for name in ("16x2", "8x4", "4x8"):
        out[f"reach_{name}_max_over_mean"] = (8 * out[f"reach_{name}_sum_of_max"]
                                              / max(out[f"reach_{name}"], 1))
    return out


def run_fwd(names, loaded, libs, dev) -> dict:
    import torch

    import chip_smoke as cs
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.raster.config import RasterConfig, production_config

    state = cs.build_state(cs.N_GAUSS, cs.CAPACITY, device=dev)
    view = orbit_camera(cs.H, cs.W, radius=6.0, azimuth=0.4, elevation=0.3, device=dev)
    bgd = torch.zeros(3, device=dev)
    inputs = {True: cs.captured_kernel_inputs(state, view, production_config(**cs.PROD), bgd),
              False: cs.captured_kernel_inputs(state, view, RasterConfig(**cs.FULL_SHAPE), bgd)}
    del state
    torch.cuda.synchronize()
    call = lambda name, kw: fwd_launch(loaded[name], *inputs[kw["packed_feats"]], **kw)

    # bit for bit against the base kernel, all eight variants
    checks = {}
    base = {}
    for train in (False, True):
        for packed in (False, True):
            for wm in (False, True):
                kw = dict(train_shape=train, packed_feats=packed, collect_wmax=wm)
                base[(train, packed, wm)] = call("fwd:base", kw)
    for name in names:
        if name == "fwd:base" or not is_right(name):
            continue
        bad = {}
        for key, (o_b, w_b) in base.items():
            kw = dict(train_shape=key[0], packed_feats=key[1], collect_wmax=key[2])
            o, w = call(name, kw)
            n_o = int((o.view(torch.int32) != o_b.view(torch.int32)).sum())
            n_w = int((w.view(torch.int32) != w_b.view(torch.int32)).sum())
            if n_o or n_w:
                bad[f"train={int(key[0])},packed={int(key[1])},wmax={int(key[2])}"] = (n_o, n_w)
        checks[name] = dict(bit_identical=not bad, differing=bad)
        print(f"check {name}: " + json.dumps(checks[name]), flush=True)
        if bad:
            raise AssertionError(f"{name} differs from the base forward: {bad}")
    del base

    times = {}
    for label, kw in FWD_CALLS.items():
        res = in_turns({name: (lambda n=name: call(n, kw)) for name in names})
        for name, v in res.items():
            times[f"{name}/{label}"] = v
            print(f"time {name} {label}: median {v['median_ms']:.4f} ms, rounds "
                  + " ".join(f"{x:.4f}" for x in v["ms"]), flush=True)
    feats, index = inputs[True]
    counts = forward_counts(feats, *index)
    print("forward counts: " + json.dumps(counts), flush=True)
    sass = {}
    for name in names:
        sass[name] = sass_loop(libs[name]["path"], "ILb1ELb1ELb0E", os.path.join(
            cs.OUT_DIR, "sass_" + re.sub(r"\W", "_", name) + ".txt"))
        print(f"sass {name} (served instantiation): {json.dumps(sass[name])}", flush=True)
    profile = {}
    for name in names:  # the profile builds' cycle counters, one launch each
        f = getattr(loaded[name], "tile_blend_fwd_profile", None)
        if f is None:
            continue
        f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int
        buf = (ctypes.c_ulonglong * 5)()
        for label, kw in FWD_CALLS.items():
            f(buf)  # zero them
            call(name, kw)
            torch.cuda.synchronize()
            if f(buf) != 0:
                raise RuntimeError(f"{name}: reading the profile failed")
            derive, pairs, ends, iters, acc_iters = (int(x) for x in buf)
            total = derive + pairs + ends
            profile[f"{name}/{label}"] = dict(
                warp_cycles=total, derive_share=derive / total, pairs_share=pairs / total,
                chunk_end_share=ends / total, pair_iterations=iters,
                accepting_iterations=acc_iters, cycles_per_iteration=pairs / max(iters, 1))
            print(f"profile {name} {label}: " + json.dumps(profile[f"{name}/{label}"]),
                  flush=True)
    occupancy = {}
    for name in names:  # this tree's builds report how many blocks fit on an SM
        f = getattr(loaded[name], "tile_blend_fwd_blocks_per_sm", None)
        if f is not None:
            occupancy[name] = {label: f(int(kw["train_shape"]), int(kw["packed_feats"]),
                                        int(kw["collect_wmax"])) for label, kw in FWD_CALLS.items()}
    print("blocks an SM: " + json.dumps(occupancy), flush=True)
    return dict(checks=checks, times=times, counts=counts, sass=sass,
                blocks_per_sm=occupancy, profile=profile,
                tiles=int(index[1].numel()), max_tile_count=int(index[1].max()))


# ---------------------------------------------------------------------------
# rows: segment_sum_rows


def run_rows(names, loaded, dev) -> dict:
    import torch

    import chip_smoke as cs
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import segment_reduce as sr
    from tpu_splat_torch.raster.config import production_config
    from tpu_splat_torch.train.step import make_train_step

    # the regroup rows of one warm-up tight step (chip_smoke.py phase 7d)
    state = cs.build_state(cs.N_GAUSS, cs.CAPACITY, cubemap=cs.TRAIN_CUBEMAP, device=dev)
    opt, ts, isp = cs.train_start(state, cs.N_VIEWS)
    step = make_train_step(opt, production_config(**cs.PROD, tight_culling=True), 1.0,
                           isp_cfg=isp)
    view = orbit_camera(cs.H, cs.W, radius=6.0, azimuth=0.4, elevation=0.3, device=dev)
    gt = torch.rand((cs.H, cs.W, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    with cs.Capture() as cap:
        step(ts, view, gt, torch.zeros(3, device=dev), frame_idx=0)
    torch.cuda.synchronize()
    (sargs, _), = cap.seen["segment_sum_ranges"]
    del state, ts, step, cap
    rows_T, starts, ends = sargs
    rows = rows_T.T.contiguous()
    want = sr.segment_sum_rows_plain(rows, starts, ends)
    scale = want.abs().amax(0)
    with Using("segment_sum_rows", loaded["rows:base"]):
        ref = sr.segment_sum_rows(rows, starts, ends)
    checks = {}
    for name in names:
        if not is_right(name):
            continue
        with Using("segment_sum_rows", loaded[name]):
            got = sr.segment_sum_rows(rows, starts, ends)
        n_bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= cs.SEGSUM_TOL * scale).all())
        checks[name] = dict(bit_identical_to_base=n_bad == 0, differing=n_bad,
                            max_abs_err_vs_plain=err)
        print(f"check {name}: " + json.dumps(checks[name]), flush=True)
        if n_bad or not ok:
            raise AssertionError(f"{name}: {checks[name]}")

    def wrapped(name):
        def fn():
            with Using("segment_sum_rows", loaded[name]):
                sr.segment_sum_rows(rows, starts, ends)
        return fn

    times = in_turns({name: wrapped(name) for name in names})
    covered = int((ends.long() - starts.long()).clamp(min=0).sum())
    n_bytes = rows.shape[1] * (covered + starts.numel()) * 4 + 2 * starts.numel() * 4
    bound_ms = n_bytes / cs.PEAK_BYTES_PER_S * 1e3
    for name, v in times.items():
        v["share_of_bound"] = bound_ms / v["median_ms"]
        print(f"time {name}: median {v['median_ms']:.4f} ms ({v['share_of_bound']:.0%} of the "
              f"{bound_ms:.4f} ms bound), rounds " + " ".join(f"{x:.4f}" for x in v["ms"]),
              flush=True)
    occupancy = {name: loaded[name].segment_sum_rows_blocks_per_sm() for name in names
                 if getattr(loaded[name], "segment_sum_rows_blocks_per_sm", None) is not None}
    print("blocks an SM: " + json.dumps(occupancy), flush=True)
    return dict(checks=checks, times=times, bound_ms=bound_ms, bytes=n_bytes, blocks_per_sm=occupancy,
                rows=int(rows.shape[0]), features=int(rows.shape[1]),
                runs=int(starts.numel()), covered_rows=covered)


# ---------------------------------------------------------------------------
# bwd and cube: tile_blend_backward and cubemap_tap_accumulate


def tap_stats(idx, w) -> dict:
    """How the bench frame's live taps fall on texels: the sums a warp (32
    pixels in the caller's order) and a block of 256 or 512 pixels would
    send on after grouping equal texels, and how the taps pile up per
    texel."""
    import torch

    live = w != 0
    pix = torch.arange(idx.shape[1], device=idx.device)
    group = lambda size, k: pix[live[k]] // size * (1 << 22) + idx[k][live[k]]
    per_tap = sum(int(torch.unique(group(32, k)).numel()) for k in range(idx.shape[0]))
    per_block = {size: int(torch.unique(torch.cat([group(size, k) for k in range(idx.shape[0])]))
                           .numel()) for size in (256, 512)}
    key = idx[live]
    hist = torch.bincount(key)
    top = torch.sort(hist, descending=True).values
    return dict(live_taps=int(key.numel()), warp_tap_groups=per_tap, block_groups=per_block,
                texels_hit=int((hist > 0).sum()), max_taps_per_texel=int(top[0]),
                top_1pct_share=float(top[: max(1, top.numel() // 100)].sum() / key.numel()))


def run_step_families(names, loaded, dev) -> dict:
    import torch

    import chip_smoke as cs
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import cubemap_accum as ca
    from tpu_splat_torch.kernels import tile_blend as tb
    from tpu_splat_torch.raster.config import production_config
    from tpu_splat_torch.train.step import make_train_step

    # the inputs one warm-up step of the bench load hands the two kernels
    state = cs.build_state(cs.N_GAUSS, cs.CAPACITY, cubemap=cs.TRAIN_CUBEMAP, device=dev)
    opt, ts, isp = cs.train_start(state, cs.N_VIEWS)
    step = make_train_step(opt, production_config(**cs.PROD), 1.0, isp_cfg=isp)
    view = orbit_camera(cs.H, cs.W, radius=6.0, azimuth=0.4, elevation=0.3, device=dev)
    gt = torch.rand((cs.H, cs.W, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    with cs.Capture() as cap:
        step(ts, view, gt, torch.zeros(3, device=dev), frame_idx=0)
    torch.cuda.synchronize()
    (bargs, bkw), = cap.seen["tile_blend_backward"]
    feats, index, fwd, ct = bargs[0], bargs[1:5], bargs[5], bargs[6]
    bkw = dict(full_grads=bkw["full_grads"], packed_feats=bkw["packed_feats"])
    (cargs, ckw), = cap.seen["cubemap_tap_accumulate"]
    del state, ts, step, cap

    out = {}
    calls, checks = {}, {}
    for name in names:
        src = SOURCES[family(name)]
        if family(name) == "bwd":
            fn = lambda: tb.tile_blend_backward(feats, *index, fwd, ct, **bkw)
        else:
            fn = lambda: ca.cubemap_tap_accumulate(*cargs, **ckw)
        calls[name] = (src, fn)
    if any(family(n) == "bwd" for n in names):
        _, tested, contributing, warp_pairs = tb.tile_blend_backward_plain(
            feats, *index, fwd, ct, return_pairs=True, **bkw)
        counts_t = index[1]
        g = torch.Generator().manual_seed(0)
        others = torch.randperm(counts_t.numel(), generator=g)[: cs.N_SAMPLED_TILES - 1].to(dev)
        tiles = torch.unique(torch.cat([torch.argmax(counts_t)[None], others]))
        out["backward_pairs"] = dict(tested_pairs=tested, contributing_pairs=contributing,
                                     contributing_warp_pairs=warp_pairs,
                                     instances=int(counts_t.long().sum()),
                                     tiles=int(counts_t.numel()))
        print("backward pairs: " + json.dumps(out["backward_pairs"]), flush=True)
    for name in names:
        if not is_right(name):
            continue
        src = calls[name][0]
        with Using(src, loaded[name]):
            if family(name) == "bwd":
                checks[name] = cs.check_backward(feats, index, fwd, ct, bkw["full_grads"],
                                                 bkw["packed_feats"], tiles)
            else:
                checks[name] = cs.check_cubemap(cargs, ckw)
        print(f"check {name}: {json.dumps(checks[name])}", flush=True)

    def wrapped(name):
        src, fn = calls[name]

        def run():
            with Using(src, loaded[name]):
                fn()
        return run

    timed = {name: wrapped(name) for name in names}
    if any(family(n) == "cube" for n in names):
        idx, w = ca.tap_rows(*cargs[1:], L=ckw["L"])
        out["cubemap_taps"] = tap_stats(idx, w)
        print("cubemap taps: " + json.dumps(out["cubemap_taps"]), flush=True)
        vals = (w[..., None] * cargs[0][None]).reshape(-1, ckw["C"])
        idx = idx.reshape(-1)
        n_texels = 6 * ckw["L"] ** 2
        timed["index_add_ of the weighted taps"] = lambda: torch.zeros(
            (n_texels, ckw["C"]), device=dev).index_add_(0, idx, vals)
        out.update(pixels=int(cargs[0].shape[0]), cubemap_L=ckw["L"])
    times = in_turns(timed)
    for name, v in times.items():
        print(f"time {name}: median {v['median_ms']:.4f} ms, rounds "
              + " ".join(f"{x:.4f}" for x in v["ms"]), flush=True)
    out.update(checks=checks, times=times)
    return out


def main() -> int:
    import torch

    if len(sys.argv) < 2 or any(f not in FAMILIES for f in sys.argv[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from tpu_splat_torch.kernels import build

    base = os.path.abspath(sys.argv[1])
    families = tuple(sys.argv[2:]) or DEFAULT_FAMILIES
    names = [n for n in VARIANTS if family(n) in families]
    dev = torch.device(cs.DEVICE)
    card = cs.card_line()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    build.build_all()
    libs = build_variants(base, os.path.join(build.BUILD_DIR, "ab"), names)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in libs.items():
        print(f"ptxas {name}: " + " | ".join(rec["ptxas"]), flush=True)
    loaded = {name: ctypes.CDLL(rec["path"]) for name, rec in libs.items()}

    res = dict(card=card, base=base, families=families,
               ptxas={name: rec["ptxas"] for name, rec in libs.items()})
    if "fwd" in families:
        res["fwd"] = run_fwd([n for n in names if family(n) == "fwd"], loaded, libs, dev)
        torch.cuda.empty_cache()
    if "rows" in families:
        res["rows"] = run_rows([n for n in names if family(n) == "rows"], loaded, dev)
        torch.cuda.empty_cache()
    if "bwd" in families or "cube" in families:
        res["step"] = run_step_families([n for n in names if family(n) in ("bwd", "cube")],
                                        loaded, dev)
    with open(os.path.join(cs.OUT_DIR, "kernel_ab.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
