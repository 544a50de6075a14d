"""Card parity of the tile-kernel path against the scan blend (port of
validate_tpu.py, tools/tpu_parity.py and tools/kernel_repro.py as one CLI).

    python -m tpu_splat_torch.tools.parity [--case all|validate|tpu_parity|kernel_repro] \
        [--size 256] [--gaussians N] [--device cuda|cpu] [--json F]

Each case renders one random scene at size x size through `rasterize` with
backend="pallas" (the tile kernels) and backend="xla" (the scan blend), on
the device, with the JAX scripts' cameras, backgrounds, capacities and
random cotangents, and holds them at those scripts' own bounds:

  validate      random_scene(5000, seed=0): the forward fields' max abs/rel
                deltas (rel < 1e-3), n_contrib mismatches, the middepth
                flips (at most max(20, H*W/1000) pixels past 1e-3), every
                parameter gradient under one cotangent (rel < 5e-4); and the
                frame held pixel by pixel as chip_smoke.py 11b holds it
                (eval/parity.py: `hold_images` with `knife_margins`).
  tpu_parity    random_scene(2500, seed=0, sh_degree=3), an L1 loss against
                a random target: loss 1e-5, colour and reflection 5e-5, the
                other maps 1e-3 of each channel's max, every gradient (SH
                included) 2e-3 of its max.
  kernel_repro  random_scene(2500, seed=0): the per-tile colour deltas
                bucketed by the tile's chunk count (128 instances), the
                worst tile, tiles over 1e-3; pass below 5e-4.

Where a row breaches, it also reports which side is nearer a float64 run of
the scan blend there. Exits 1 on any breach.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.data.synthetic import orbit_camera, random_scene
from tpu_splat_torch.eval.parity import KNIFE_BAND, hold_images, knife_margins, patched_blend
from tpu_splat_torch.raster import rasterize
from tpu_splat_torch.raster.config import TILE, RasterConfig, tile_grid

CASES = ("validate", "tpu_parity", "kernel_repro")
# Gaussians, the SH degree random_scene draws, the degree rasterize renders
# (validate_tpu.py renders the DC-only scene at degree 3, as it does)
SCENE = {"validate": (5000, 0, 3), "tpu_parity": (2500, 3, 3), "kernel_repro": (2500, 0, 0)}
BG = {"validate": (0.15, 0.25, 0.35), "tpu_parity": (0.1, 0.2, 0.3),
      "kernel_repro": (0.1, 0.2, 0.3)}
CAPS = {"validate": dict(max_tiles_per_gaussian=32, max_instances=1 << 17, tile_depth=1024,
                         chunk=32),
        "tpu_parity": dict(max_tiles_per_gaussian=64, max_instances=1 << 18, tile_depth=4096,
                           chunk=32),
        "kernel_repro": dict(max_tiles_per_gaussian=64, max_instances=1 << 18, tile_depth=4096,
                             chunk=32)}
FWD_REL = 1e-3  # validate: forward fields, relative to the scan's max
GRAD_REL = 5e-4  # validate: gradients, relative to the scan's max
MIDDEPTH_CH = 5
TP_TOL = dict(loss=1e-5, color=5e-5, others=1e-3, refl_map=5e-5, grad=2e-3)  # tpu_parity
REPRO_TOL = 5e-4  # kernel_repro: the largest colour delta
REPRO_TILE_FLAG = 1e-3
CHUNK_INSTANCES = 128  # kernel_repro's bucket: the JAX kernel's chunk of instances


def _leaves(n: int, sh_degree: int, device) -> dict:
    """random_scene(n, seed=0) activated as the JAX scripts do."""
    raw = random_scene(n, seed=0, sh_degree=sh_degree)
    t = lambda a: torch.as_tensor(a, device=device)
    return dict(means3d=t(raw["xyz"]), scales=f32.exp(t(raw["scaling"])),
                rotations=t(raw["rotation"]), opacity=f32.sigmoid(t(raw["opacity"][:, 0])),
                refl=f32.sigmoid(t(raw["refl"][:, 0])), sh=t(raw["sh"]))


def _frame(p: dict, cam, bg, cfg, sh_degree: int, record=None, dtype=None):
    with patched_blend(dtype=dtype, record=record):
        return rasterize(p["means3d"], p["scales"], p["rotations"], p["opacity"], p["refl"],
                         cam, bg, cfg, sh=p["sh"], sh_degree=sh_degree)


def _grads(p: dict, names, cam, bg, cfg, sh_degree, loss_fn):
    leaves = {k: v.detach().clone().requires_grad_(k in names) for k, v in p.items()}
    out = _frame(leaves, cam, bg, cfg, sh_degree)
    loss = loss_fn(out)
    got = torch.autograd.grad(loss, [leaves[k] for k in names])
    return float(loss.detach()), out, dict(zip(names, got))


def _row(name, a, b, bound, rel=True):
    """One check: max |a - b|, relative to max |b| when `rel`, against
    `bound`."""
    d = float((a - b).abs().max()) if a.numel() else 0.0
    r = d / (float(b.abs().max()) + 1e-12)
    return dict(name=name, max_abs=d, rel=r, bound=bound, relative=rel,
                ok=bool((r if rel else d) <= bound))


def _nearer_f64(row, kernel, scan, f64):
    """For a breaching row: at its worst entries, the kernel's and the scan
    blend's distance to the float64 scan blend."""
    d = (kernel - scan).abs().reshape(-1)
    idx = torch.topk(d, min(16, d.numel())).indices
    k64 = float((kernel.reshape(-1)[idx].double() - f64.reshape(-1)[idx].double()).abs().max())
    s64 = float((scan.reshape(-1)[idx].double() - f64.reshape(-1)[idx].double()).abs().max())
    row.update(kernel_to_f64=k64, scan_to_f64=s64,
               nearer_f64="kernel" if k64 < s64 else "scan" if s64 < k64 else "tie")


def _print_rows(case, rows):
    for r in rows:
        extra = "".join(f" {k} {r[k]:.3e}" for k in ("kernel_to_f64", "scan_to_f64") if k in r)
        if "nearer_f64" in r:
            extra += f" nearer_f64 {r['nearer_f64']}"
        print(f"[{case}] {r['name']:26s} max_abs {r['max_abs']:.3e} rel {r['rel']:.3e} "
              f"(bound {r['bound']:g}{' rel' if r['relative'] else ''}) "
              f"{'ok' if r['ok'] else 'FAIL'}{extra}", flush=True)


def _configs(case):
    caps = CAPS[case]
    return RasterConfig(**caps, backend="pallas"), RasterConfig(**caps, backend="xla")


def case_validate(size, n, dev) -> dict:
    """validate_tpu.py: forward fields and parameter gradients."""
    H = W = size
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3, device=dev)
    pal, xla = _configs("validate")
    p = _leaves(n, SCENE["validate"][1], dev)
    bg = torch.tensor(BG["validate"], device=dev)
    rng = np.random.default_rng(1)
    ct_img = torch.as_tensor(rng.normal(size=(H, W, 3)).astype(np.float32), device=dev)
    ct_oth = torch.as_tensor(rng.normal(size=(H, W, 8)).astype(np.float32), device=dev)
    ct_refl = torch.as_tensor(rng.normal(size=(H, W)).astype(np.float32), device=dev)
    ct_oth[..., MIDDEPTH_CH] = 0.0  # the median flips at T ~ 0.5 between blends

    def loss_fn(o):
        return ((o.color * ct_img).sum() + (o.others * ct_oth).sum()
                + (o.refl_map * ct_refl).sum())

    names = ("means3d", "scales", "rotations", "opacity", "refl")
    deg = SCENE["validate"][2]
    _, op, gp = _grads(p, names, cam, bg, pal, deg, loss_fn)
    _, ox, gx = _grads(p, names, cam, bg, xla, deg, loss_fn)
    rows = []
    for f in ("color", "final_T", "refl_map", "gaussian_weights"):
        rows.append(_row(f"fwd {f}", getattr(op, f).detach(), getattr(ox, f).detach(), FWD_REL))
    a, b = op.others.detach(), ox.others.detach()
    flip_bound = max(20, H * W // 1000)
    for c in range(8):
        d = (a[..., c] - b[..., c]).abs()
        n_bad = int((d > 1e-3).sum())
        if c == MIDDEPTH_CH:
            rows.append(dict(name="fwd middepth flips", max_abs=float(d.max()), rel=float(n_bad),
                             bound=flip_bound, ok=n_bad <= flip_bound, relative=False))
        else:
            r = _row(f"fwd others ch{c}", a[..., c], b[..., c], 1e-3)
            r["ok"] = r["max_abs"] < 1e-3 or r["rel"] < 1e-3
            rows.append(r)
    for k in names:
        rows.append(_row(f"grad {k}", gp[k], gx[k], GRAD_REL))
    # the frame pixel by pixel, as chip_smoke.py 11b holds it
    rec = []
    with torch.no_grad():
        o_scan = _frame(p, cam, bg, xla, deg, record=rec)
        _, px_margin, _ = knife_margins(rec[0])
        near_knife = px_margin.amin(0) < KNIFE_BAND
        try:
            held = hold_images(o_scan, _frame(p, cam, bg, pal, deg), "validate frame", near_knife)
            held_ok = True
        except AssertionError as e:  # reported as a failed row
            held, held_ok = dict(error=str(e)), False
    held["near_knife_pixels"] = int(near_knife.sum())
    rows.append(dict(name="frame hold (knife margins)", max_abs=held.get("color", float("nan")),
                     rel=float(held.get("ncon_flips", -1)), bound=0.0, ok=held_ok,
                     relative=False))
    return dict(rows=rows, n_contrib_mismatches=int((op.n_contrib != ox.n_contrib).sum()),
                instances=int(op.num_instances), max_tile=int(op.tile_counts.max()),
                hold=held, f64=lambda: _frame(p, cam, bg, xla, deg, dtype=torch.float64),
                outputs=(op, ox))


def case_tpu_parity(size, n, dev) -> dict:
    """tools/tpu_parity.py: an L1 loss against a random target, its value,
    the maps and every gradient (SH included)."""
    H = W = size
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3, device=dev)
    pal, xla = _configs("tpu_parity")
    p = _leaves(n, SCENE["tpu_parity"][1], dev)
    bg = torch.tensor(BG["tpu_parity"], device=dev)
    tgt = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32),
                          device=dev)

    def loss_fn(o):
        return (torch.mean(torch.abs(o.color - tgt)) + 0.1 * torch.mean(o.others[..., 2:5] ** 2)
                + 0.1 * torch.mean(o.refl_map))

    names = ("means3d", "scales", "rotations", "opacity", "refl", "sh")
    deg = SCENE["tpu_parity"][2]
    lp, op, gp = _grads(p, names, cam, bg, pal, deg, loss_fn)
    lx, ox, gx = _grads(p, names, cam, bg, xla, deg, loss_fn)
    t64 = lambda v: torch.tensor([v], dtype=torch.float64)
    rows = [_row("loss", t64(lp), t64(lx), TP_TOL["loss"], rel=False),
            _row("color", op.color.detach(), ox.color.detach(), TP_TOL["color"], rel=False),
            _row("refl_map", op.refl_map.detach(), ox.refl_map.detach(), TP_TOL["refl_map"],
                 rel=False)]
    o_scale = ox.others.detach().abs().reshape(-1, 8).amax(0) + 1e-6
    rows.append(_row("others (rel)", op.others.detach() / o_scale, ox.others.detach() / o_scale,
                     TP_TOL["others"], rel=False))
    rows += [_row(f"d_{k}", gp[k], gx[k], TP_TOL["grad"]) for k in names]
    return dict(rows=rows, instances=int(op.num_instances), max_tile=int(op.tile_counts.max()),
                max_area=int(op.max_area), cap=pal.max_instances,
                f64=lambda: _frame(p, cam, bg, xla, deg, dtype=torch.float64),
                outputs=(op, ox))


def case_kernel_repro(size, n, dev) -> dict:
    """tools/kernel_repro.py: the per-tile colour deltas by chunk count."""
    H = W = size
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3, device=dev)
    pal, xla = _configs("kernel_repro")
    p = _leaves(n, SCENE["kernel_repro"][1], dev)
    bg = torch.tensor(BG["kernel_repro"], device=dev)
    with torch.no_grad():
        op, ox = _frame(p, cam, bg, pal, 0), _frame(p, cam, bg, xla, 0)  # degree 0, as drawn
    ty, tx = tile_grid(H, W)
    d = (op.color - ox.color).abs().amax(-1)
    dt = torch.zeros((ty * TILE, tx * TILE), dtype=d.dtype, device=d.device)
    dt[:H, :W] = d
    per_tile = dt.reshape(ty, TILE, tx, TILE).amax((1, 3)).reshape(-1)
    counts = op.tile_counts[: ty * tx].long()
    chunks = (counts + CHUNK_INSTANCES - 1) // CHUNK_INSTANCES
    buckets = {int(c): dict(tiles=int((chunks == c).sum()),
                            max_delta=float(per_tile[chunks == c].max()))
               for c in torch.unique(chunks).tolist()}
    worst = int(torch.argmax(per_tile))
    return dict(rows=[_row("color", op.color, ox.color, REPRO_TOL, rel=False)],
                instances=int(op.num_instances), max_tile=int(counts.max()),
                final_T_delta=float((op.final_T - ox.final_T).abs().max()),
                chunk_buckets=buckets,
                worst_tile=dict(tile=worst, chunks=int(chunks[worst]), count=int(counts[worst]),
                                delta=float(per_tile[worst])),
                tiles_over_1e3=int((per_tile > REPRO_TILE_FLAG).sum()), tiles=ty * tx,
                f64=lambda: _frame(p, cam, bg, xla, 0, dtype=torch.float64),
                outputs=(op, ox))


RUNNERS = {"validate": case_validate, "tpu_parity": case_tpu_parity,
           "kernel_repro": case_kernel_repro}


def _judge(res: dict) -> None:
    """Rows that breach: which side is nearer the float64 scan blend, on
    the forward maps (the gradients' float64 judge is the witness
    tests/scan_grad_witness.py)."""
    bad = [r for r in res["rows"] if not r["ok"]]
    if not bad:
        return
    with torch.no_grad():
        o64 = res["f64"]()
    op, ox = res["outputs"]
    for r in bad:
        field = r["name"].split()[1] if r["name"].startswith("fwd ") else r["name"].split()[0]
        if field.startswith("others") or field == "middepth":
            field = "others"
        if field in ("color", "final_T", "refl_map", "gaussian_weights", "others"):
            _nearer_f64(r, getattr(op, field).detach(), getattr(ox, field).detach(),
                        getattr(o64, field))


def run(cases=CASES, size: int = 256, gaussians: int | None = None, device="cuda") -> dict:
    """Run the cases; -> {case: result} with "ok" over all of them."""
    dev = resolve_device(device)
    out, ok = {}, True
    for case in cases:
        n = gaussians or SCENE[case][0]
        res = RUNNERS[case](size, n, dev)
        _judge(res)
        _print_rows(case, res["rows"])
        extra = {k: v for k, v in res.items() if k not in ("rows", "f64", "outputs")}
        print(f"[{case}] {json.dumps(extra)}", flush=True)
        case_ok = all(r["ok"] for r in res["rows"])
        print(f"[{case}] {'PASS' if case_ok else 'FAIL'}", flush=True)
        ok &= case_ok
        out[case] = dict(extra, rows=res["rows"], ok=case_ok, gaussians=n, size=size)
    out["ok"] = ok
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=("all",) + CASES, default="all")
    ap.add_argument("--size", type=int, default=256, help="H = W")
    ap.add_argument("--gaussians", type=int, default=0, help="override each case's count")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default="", help="write the rows here")
    args = ap.parse_args(argv)
    cases = CASES if args.case == "all" else (args.case,)
    res = run(cases, args.size, args.gaussians or None, args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print("PARITY " + ("PASS" if res["ok"] else "FAIL"), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
