#!/usr/bin/env python3
"""The two redesigned kernels against another tree's, on one card.

    python3 kernel_ab.py BASE_TREE

BASE_TREE is another checkout of the repository (for instance `git archive`
of an earlier commit unpacked under `tpu_splat_torch/_build/`, which git
ignores). The script builds, one `nvcc` each and all at once, the base
tree's `tile_blend_bwd.cu` and `cubemap_accum.cu`, this tree's, and their
variants:

- `bwd:base_one_shuffle`: the base backward with its per-instance
  reduction cut to one shuffle (wrong sums, timed only): what the
  reduction costs in the base design;
- `bwd:sub32`, `bwd:sub128`: this backward reducing 32 or 128 instances a
  round (`-DBWD_SUB`; 64 by default); `bwd:min1`, `bwd:min2`: with one or
  two blocks an SM as its launch bound (`-DBWD_MIN_BLOCKS`; 3 by default),
  `bwd:sub32_min4`: four blocks of 32 instances a round;
- `cube:warp_only`: this cubemap kernel without its block table, each
  warp group's sum sent to device memory (`-DCUBEMAP_TABLE=0`), and
  `cube:warp_only_no_atomics`, the same without its atomics (wrong sums,
  timed only): what those atomics cost;
- `cube:direct`: no table and no warp grouping, every lane issuing its own
  atomics (the base design's traffic); `cube:table_no_grouping`: the table
  without the warp grouping; `cube:table1024`: a 1024-slot table;
  `cube:threads256`, `cube:threads1024`: blocks of 256 or 1024 pixels
  (`-DCUBEMAP_THREADS`; 512 by default).

It then runs one warm-up training step of the bench load (chip_smoke.py
phase 6c: 1M Gaussians, 1088x1920, the trainer's 128^2 cubemap, production
switches, the ISP on), keeps the inputs that step hands both kernels, holds
every variant whose sums stay right against the plain version (BWD_TOL on 64
sampled tiles, CUBEMAP_TOL), and times each variant with CUDA events in
the order base, this, variants, then back, ROUNDS times (median of the
rounds). It also counts the (instance, warp) pairs holding a contributor
and how the taps fall on texels, and times one `index_add_` of the
weighted taps. It prints each result, the registers and spills `ptxas`
reports, the card's name and power limit, and writes everything to
chiprun_out/kernel_ab.json.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 5
REPS = 5

# variant name -> (source, the tree it comes from, extra nvcc flags, the
# patch applied to its text or None)
VARIANTS = {
    "bwd:base": ("tile_blend_bwd", "base", (), None),
    "bwd:base_one_shuffle": ("tile_blend_bwd", "base", (), "one_shuffle"),
    "bwd:this": ("tile_blend_bwd", "this", (), None),
    "bwd:sub32": ("tile_blend_bwd", "this", ("-DBWD_SUB=32",), None),
    "bwd:sub128": ("tile_blend_bwd", "this", ("-DBWD_SUB=128",), None),
    "bwd:min1": ("tile_blend_bwd", "this", ("-DBWD_MIN_BLOCKS=1",), None),
    "bwd:min2": ("tile_blend_bwd", "this", ("-DBWD_MIN_BLOCKS=2",), None),
    "bwd:sub32_min4": ("tile_blend_bwd", "this", ("-DBWD_SUB=32", "-DBWD_MIN_BLOCKS=4"), None),
    "cube:base": ("cubemap_accum", "base", (), None),
    "cube:this": ("cubemap_accum", "this", (), None),
    "cube:warp_only": ("cubemap_accum", "this", ("-DCUBEMAP_TABLE=0",), None),
    "cube:warp_only_no_atomics": ("cubemap_accum", "this", ("-DCUBEMAP_TABLE=0",), "no_atomics"),
    "cube:direct": ("cubemap_accum", "this", ("-DCUBEMAP_TABLE=0",), "no_grouping"),
    "cube:table_no_grouping": ("cubemap_accum", "this", (), "no_grouping"),
    "cube:table1024": ("cubemap_accum", "this", ("-DCUBEMAP_TABLE=1024",), None),
    "cube:threads256": ("cubemap_accum", "this", ("-DCUBEMAP_THREADS=256",), None),
    "cube:threads1024": ("cubemap_accum", "this", ("-DCUBEMAP_THREADS=1024",), None),
}
# patch name -> (text, its replacement, whether the result is still right)
PATCHES = {
    # the base backward's per-instance reduction cut to one shuffle
    "one_shuffle": ("""        if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
          for (int k = 0; k < NSUM; ++k) v[k] = warp_sum(v[k]);
        }""", """        if (__any_sync(0xffffffffu, contrib)) {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
        }""", False),
    # the cubemap kernel without its atomics (the sums kept live)
    "no_atomics": ("  if (live && rank == 0) texel_add<C>(s_key, s_val, out, key, v);",
                   "  if (live && rank == 0 && v[0] == 1.2345e-30f)\n"
                   "    texel_add<C>(s_key, s_val, out, key, v);", False),
    # every lane a group of its own: no warp grouping
    "no_grouping": ("  const unsigned peers = __match_any_sync(FULL, key);",
                    "  const unsigned peers = 1u << lane;", True),
}


def build_variants(base: str, out_dir: str) -> dict:
    """Compile every variant at once; -> name -> {path, ptxas, seconds}."""
    from tpu_splat_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, tree, flags, patch) in VARIANTS.items():
        root = build.PKG_DIR if tree == "this" else os.path.join(base, "tpu_splat_torch")
        path = os.path.join(root, "csrc", f"{src}.cu")
        if patch is not None:
            old, new, _ = PATCHES[patch]
            text = open(path).read()
            if old not in text:
                raise RuntimeError(f"{name}: the text to replace is not in {path}")
            path = os.path.join(out_dir, f"{src}_{tree}_{patch}.cu")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
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


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import build
    from tpu_splat_torch.kernels import cubemap_accum as ca
    from tpu_splat_torch.kernels import tile_blend as tb
    from tpu_splat_torch.raster.config import production_config
    from tpu_splat_torch.train.step import make_train_step

    base = os.path.abspath(sys.argv[1])
    dev = torch.device(cs.DEVICE)
    card = cs.card_line()
    t0 = time.perf_counter()
    build.build_all()
    libs = build_variants(base, os.path.join(build.BUILD_DIR, "ab"))
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in libs.items():
        print(f"ptxas {name}: " + " | ".join(rec["ptxas"]), flush=True)
    loaded = {name: ctypes.CDLL(rec["path"]) for name, rec in libs.items()}

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

    _, tested, contributing, warp_pairs = tb.tile_blend_backward_plain(
        feats, *index, fwd, ct, return_pairs=True, **bkw)
    counts_t = index[1]
    g = torch.Generator().manual_seed(0)
    others = torch.randperm(counts_t.numel(), generator=g)[: cs.N_SAMPLED_TILES - 1].to(dev)
    tiles = torch.unique(torch.cat([torch.argmax(counts_t)[None], others]))

    calls = {}
    checks = {}
    for name, (src, _, _, patch) in VARIANTS.items():
        if src == "tile_blend_bwd":
            fn = lambda: tb.tile_blend_backward(feats, *index, fwd, ct, **bkw)
        else:
            fn = lambda: ca.cubemap_tap_accumulate(*cargs, **ckw)
        calls[name] = (src, fn)
        if patch is not None and not PATCHES[patch][2]:
            continue
        with Using(src, loaded[name]):
            if src == "tile_blend_bwd":
                checks[name] = cs.check_backward(feats, index, fwd, ct, bkw["full_grads"],
                                                 bkw["packed_feats"], tiles)
            else:
                checks[name] = cs.check_cubemap(cargs, ckw)
        print(f"check {name}: {json.dumps(checks[name])}", flush=True)

    idx, w = ca.tap_rows(*cargs[1:], L=ckw["L"])
    taps = tap_stats(idx, w)
    print("cubemap taps: " + json.dumps(taps), flush=True)
    vals = (w[..., None] * cargs[0][None]).reshape(-1, ckw["C"])
    idx = idx.reshape(-1)
    n_texels = 6 * ckw["L"] ** 2

    def lib_call():
        torch.zeros((n_texels, ckw["C"]), device=dev).index_add_(0, idx, vals)

    order = list(VARIANTS)
    times = {name: [] for name in order}
    lib_times = []
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            src, fn = calls[name]
            with Using(src, loaded[name]):
                times[name].append(cs.cuda_ms(fn, REPS))
        lib_times.append(cs.cuda_ms(lib_call, REPS))
    res = {name: dict(median_ms=float(np.median(t)), ms=t, ptxas=libs[name]["ptxas"],
                      check=checks.get(name)) for name, t in times.items()}
    for name, v in res.items():
        print(f"time {name}: median {v['median_ms']:.4f} ms, rounds "
              + " ".join(f"{x:.4f}" for x in v["ms"]), flush=True)
    lib_ms = float(np.median(lib_times))
    print(f"time index_add_ of the weighted taps: median {lib_ms:.4f} ms", flush=True)
    pairs = dict(tested_pairs=tested, contributing_pairs=contributing,
                 contributing_warp_pairs=warp_pairs,
                 instances=int(counts_t.long().sum()), tiles=int(counts_t.numel()))
    print("backward pairs: " + json.dumps(pairs), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "kernel_ab.json"), "w") as f:
        json.dump(dict(card=card, base=base, variants=res, index_add_ms=lib_ms,
                       backward_pairs=pairs, pixels=int(cargs[0].shape[0]),
                       cubemap_L=ckw["L"], cubemap_taps=taps), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
