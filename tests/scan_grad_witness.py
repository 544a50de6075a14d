"""Which of the two blends is nearer the exact one where the scan blend's
training step and the tile kernels' step disagree, on one CUDA card.

chip_smoke.py phase 11b holds one training step through the scan blend
(backend="xla", float32) against the same step through the tile kernels,
on the bench cloud (1M Gaussians) at 1088x1920. This script takes that
step as the kernels (K), the scan blend in float32 (S) and the scan blend
in float64 (R: its inputs cast up, its outputs rounded back, the rest of
the step in float32 as in the other two), and as the kernels with their
blend outputs jittered, relative, by 2^-22 (Kp) and by
chip_smoke.P11_JITTER under four seeds (J, the largest move from K). For
each leaf, and for the gradients reaching the blend's inputs (`blend_d*`,
before the preprocess VJP), it prints the rows (a Gaussian's, or one
entry of another leaf) where each pair parts by more than 1e-3 of the
leaf's largest |K|, which of K and S is nearer R on the rows where they
part, how many of those rows the jitters move, and for the Gaussians how
near each branch point of the blend (chip_smoke.knife_margins, in
float64) they come at any pixel. Then the same at the blend alone: one
seeded cotangent on the rasterizer's outputs, the blends' input
gradients. Last the frames, pixel by pixel. Detail goes to
chiprun_out/scan_grad_witness.json.

    python3 tests/scan_grad_witness.py

Run from the repository root with one CUDA card visible (~75 s
after the kernels' build, ~40 GiB of device memory at the peak).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

TOL = 1e-3  # of each leaf's largest |K|, the hold of chip_smoke.py 11b
BANDS = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3)
TOP = 12  # rows printed a leaf
NOISE = 2.0**-22  # Kp: the kernel path's blend outputs jittered by this, relative
N_JITTER = 4  # J: K's largest move, row by row, under this many jitters of chip_smoke.P11_JITTER


def compare_rows(grads, P, g_m, n_px, label):
    """Each leaf of grads["K"] against the same leaf of the others: the rows
    (a Gaussian's, or one entry of another leaf) beyond TOL of the leaf's
    largest |K|, per pair, which of K and S is nearer R there, and the
    Gaussians' least knife margins."""
    import torch

    import chip_smoke as cs
    from tpu_splat_torch.eval import parity

    pairs = [("K", "S"), ("K", "R"), ("S", "R")] + ([("K", "Kp")] if "Kp" in grads else [])
    g_min = g_m.amin(0)
    out = {}
    for k, gk in grads["K"].items():
        scale = max(float(gk.abs().max()), 1e-30)
        per_row = gk.shape[0] == P
        n = gk.shape[0] if per_row else gk.numel()
        e = {a + b: (grads[a][k] - grads[b][k]).reshape(n, -1).abs().amax(1) / scale
             for a, b in pairs}
        over = e["KS"] > TOL
        rows = torch.nonzero(over).flatten()
        rows = rows[torch.argsort(e["KS"][rows], descending=True)]
        leaf = dict(rows=n, **{f"over_{p}": int((v > TOL).sum()) for p, v in e.items()},
                    worst={p: float(v.max()) for p, v in e.items()},
                    S_nearer=int((e["SR"][rows] < e["KR"][rows]).sum()),
                    K_nearer=int((e["KR"][rows] < e["SR"][rows]).sum()))
        if "J" in grads:
            jm = grads["J"][k].reshape(n, -1).amax(1) / scale
            e["J"] = jm
            leaf["jitter_over"] = {f"{t:g}": int((jm > t).sum()) for t in (TOL, TOL / 2, TOL / 4)}
            leaf["over_KS_jitter_over"] = {f"{t:g}": int((over & (jm > t)).sum())
                                           for t in (TOL, TOL / 2, TOL / 4)}
            leaf["worst"]["J"] = float(jm.max())
        for p in ("KS", "KR", "SR"):
            r2 = torch.nonzero(e[p] > TOL).flatten()
            if per_row and r2.numel():
                leaf[f"over_{p}_margin_under"] = {f"{b:g}": int((g_min[r2] < b).sum())
                                                  for b in BANDS}
        leaf["top"] = [dict(row=int(r), **{p: float(v[r]) for p, v in e.items()},
                            **({"pixels": int(n_px[r]),
                                "margins": {kn: float(g_m[i, r]) for i, kn in
                                            enumerate(parity.KNIVES)}} if per_row else {}))
                       for r in rows[:TOP].tolist()]
        out[k] = leaf
        print(f"[witness] {label} {k}: "
              + json.dumps({x: y for x, y in leaf.items() if x != "top"}), flush=True)
        for t in leaf["top"]:
            print(f"[witness]   {label} {k} " + json.dumps(t), flush=True)
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpu_splat_torch.eval import parity
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import build
    from tpu_splat_torch.raster import rasterize
    from tpu_splat_torch.raster.config import RasterConfig
    from tpu_splat_torch.train.grow import check_growth
    from tpu_splat_torch.train.step import make_train_step

    if not torch.cuda.is_available():
        print("scan_grad_witness: no CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    dev = torch.device(cs.DEVICE)
    card = cs.card_line()
    state = cs.build_state(cs.N_GAUSS, cs.CAPACITY, device=dev)
    cam = orbit_camera(cs.H, cs.W, radius=6.0, azimuth=0.4, elevation=0.3, device=dev)
    bgd = torch.zeros(3, device=dev)
    opt, ts, isp = cs.train_start(state, cs.N_VIEWS)
    # 11b's configurations: tile_depth grown by check_growth from the first
    # frame's max_tile_count
    scan_cfg = RasterConfig(**dict(cs.PROD, tile_depth=cs.P11_SCAN_FIRST_DEPTH), backend="xla")
    with torch.no_grad():
        first = rasterize(state.xyz, state.get_scaling(), state.rotation, state.get_opacity(),
                          state.get_refl(), cam, bgd, scan_cfg, sh=state.get_features(),
                          sh_degree=state.max_sh_degree, alive=state.alive)
    dec = check_growth(ts, scan_cfg, n_alive=int(state.alive.sum()),
                       num_instances=int(first.num_instances),
                       max_tile_count=int(first.tile_counts.max()), densify_overflow=0,
                       pad_overflow=0)
    scan_cfg = dec.cfg
    ker_cfg = dataclasses.replace(scan_cfg, backend="auto")
    del first
    print(f"[witness] card={card!r} tile_depth={scan_cfg.tile_depth} "
          f"max_instances={scan_cfg.max_instances}", flush=True)

    gt0 = torch.rand((cs.H, cs.W, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    grads, losses, rec = {}, {}, []
    steps = [("K", ker_cfg, None, (None, 0)), ("Kp", ker_cfg, None, (NOISE, 0)),
             ("S", scan_cfg, None, (None, 0)), ("R", scan_cfg, torch.float64, (None, 0))]
    steps += [(f"J{i}", ker_cfg, None, (cs.P11_JITTER, i)) for i in range(N_JITTER)]
    for name, c, dt, noise in steps:
        step = make_train_step(opt, c, 1.0, isp_cfg=isp)
        torch.cuda.reset_peak_memory_stats()
        edge = {}
        with parity.patched_blend(dtype=dt, record=rec if name == "S" else None), \
                cs.blend_inputs(edge), cs.jittered_kernel_maps(*noise):
            ms, (_, aux) = cs.wall_ms(lambda: step(ts, cam, gt0, bgd, frame_idx=0))
        grads[name] = {k: v.detach() for k, v in aux.grads.items()}
        grads[name].update({f"blend_d{k}": v for k, v in edge.items()})
        losses[name] = float(aux.loss)
        if name.startswith("J"):  # keep only the largest move from K, row by row
            moved = {k: (v - grads["K"][k]).abs() for k, v in grads.pop(name).items()}
            grads["J"] = moved if "J" not in grads else {
                k: torch.maximum(grads["J"][k], v) for k, v in moved.items()}
        print(f"[witness] step {name}: {ms:.1f} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss {losses[name]!r}",
              flush=True)
        del aux, step
    rec = rec[0]
    torch.cuda.empty_cache()
    g_m, p_m, n_px = parity.knife_margins(rec)
    g_min = g_m.amin(0)
    alive = state.alive
    P = alive.shape[0]
    near_share = {f"{b:g}": int(((g_min < b) & alive).sum()) for b in BANDS}
    print(f"[witness] Gaussians whose least knife margin is under each band, of "
          f"{int(alive.sum())} alive: {json.dumps(near_share)}", flush=True)
    out = dict(card=card, losses=losses, tile_depth=scan_cfg.tile_depth,
               gaussians_near_a_knife=near_share,
               step=compare_rows(grads, P, g_m, n_px, "step"))
    del grads

    # the blends alone: one common cotangent (seeded) on the rasterizer's
    # colour, maps and reflection strength, the gradients at the blend's
    # inputs compared as above
    gen = torch.Generator().manual_seed(5)
    cot = [torch.rand(sh, generator=gen).to(dev) - 0.5 for sh in
           ((cs.H, cs.W, 3), (cs.H, cs.W, 8), (cs.H, cs.W))]
    vjps = {}
    for name, c, dt in (("K", ker_cfg, None), ("S", scan_cfg, None), ("R", scan_cfg, torch.float64)):
        edge = {}
        leaves = [t.detach().requires_grad_() for t in
                  (state.xyz, state.get_scaling(), state.rotation, state.get_opacity())]
        with parity.patched_blend(dtype=dt), cs.blend_inputs(edge):
            o = rasterize(*leaves, state.get_refl().detach(), cam, bgd, c,
                          sh=state.get_features().detach(), sh_degree=state.max_sh_degree,
                          alive=state.alive)
            loss = sum((m * w).sum() for m, w in zip((o.color, o.others, o.refl_map), cot))
            torch.autograd.grad(loss, leaves)
        vjps[name] = {f"d{k}": v for k, v in edge.items()}
        del o, loss, leaves
    out["common_cotangent"] = compare_rows(vjps, P, g_m, n_px, "common cotangent")
    del vjps

    # the frames, pixel by pixel: n_contrib flips and pixels off 11b's
    # tolerances, each pair of the three, with the least knife margin there
    def frame(c, dt=None):
        with torch.no_grad(), parity.patched_blend(dtype=dt):
            return rasterize(state.xyz, state.get_scaling(), state.rotation,
                             state.get_opacity(), state.get_refl(), cam, bgd, c,
                             sh=state.get_features(), sh_degree=state.max_sh_degree,
                             alive=state.alive)

    frames = {"K": frame(ker_cfg), "S": frame(scan_cfg), "R": frame(scan_cfg, torch.float64)}
    p_min = p_m.amin(0)
    out["frames"] = {}
    for a, b in (("K", "S"), ("K", "R"), ("S", "R")):
        fa, fb = frames[a], frames[b]
        flip = fa.n_contrib != fb.n_contrib
        off = flip.clone()
        for f, (atol, rtol) in parity.IMG_TOL.items():
            x, y = getattr(fa, f), getattr(fb, f)
            o = (x - y).abs() > atol + rtol * y.abs()
            off |= o.any(-1) if o.dim() == 3 else o
        excess = {}
        for f in parity.IMG_TOL:
            d = (getattr(fa, f) - getattr(fb, f)).abs()
            d = d.amax(-1) if d.dim() == 3 else d
            excess[f] = [float(d[~off].max()), float(d[off & ~flip].max()) if bool((off & ~flip).any()) else 0.0,
                         float(d[flip].max()) if bool(flip.any()) else 0.0]
        res = dict(flips=int(flip.sum()), off=int(off.sum()),
                   max_diff_kept_off_flipped=excess,
                   off_margin_under={f"{bd:g}": int((p_min[off] < bd).sum()) for bd in BANDS},
                   off_least_margin_max=float(p_min[off].max()) if bool(off.any()) else 0.0)
        out["frames"][a + b] = res
        print(f"[witness] frame {a} vs {b}: {json.dumps(res)}", flush=True)
    px_share = {f"{bd:g}": int((p_min < bd).sum()) for bd in BANDS}
    out["pixels_near_a_knife"] = px_share
    print(f"[witness] pixels whose least knife margin is under each band, of "
          f"{p_min.numel()}: {json.dumps(px_share)}", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "scan_grad_witness.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"[witness] card={card!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
