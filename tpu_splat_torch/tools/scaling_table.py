"""Multi-rank work table of the training step (port of tools/scaling_table.py).

    python -m tpu_splat_torch.tools.scaling_table [--ranks 1 2 4] [--size 192] \
        [--gaussians 12000] [--out SCALING_torch.md]

Runs one tile-sharded step (`make_train_step(mesh=...)`) and one camera-DP
step (`make_train_step_dp`) over 1, 2 and 4 ranks started by
`dist/mesh.py:launch` over gloo on the CPU, on the JAX tool's scene
(random_scene(12000, seed=1, sh_degree=3) in a 2^14 capacity, 192x192,
RasterConfig(16, 2^17, 1024, 16)), in the deferred-reflection stage so the
env pass runs too. The port has no compiler cost analysis; instead each
rank records:

- its instances (the sum of the tile counts its forward kernel gets) and
  the (instance, pixel) pairs that kernel tests (the plain version's count,
  early termination included), beside the unsharded step's;
- each collective of `dist/collectives.py` by call site: its calls and the
  bytes the rank puts into it (an all-reduce's buffer, an all-gather's
  part), as the tensors at the site imply them; and the bytes the gloo calls
  actually carried, which must equal their sum;
- the work every rank repeats in full: the Gaussians preprocessed, the loss
  pixels, the Adam values.

Wall seconds are printed as host copies, not scaling: the ranks share the
host's cores. Writes SCALING_torch.md (SCALING.md stays the JAX package's).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import time

import numpy as np
import torch

import tpu_splat_torch.dist.collectives as collectives

RANKS = (1, 2, 4)
MODES = ("tiles", "dp")
# (module, name) of each call site of dist/collectives.py on the two steps,
# and its label
SITES = (
    ("tpu_splat_torch.raster.sharded", "replicated",
     "table all-reduce: the blend inputs' per-Gaussian gradients (backward)"),
    ("tpu_splat_torch.raster.sharded", "all_max_", "gaussian_weights and diagnostics all-max"),
    ("tpu_splat_torch.raster.sharded", "gather_rows", "slab gather: out_px rows, tile counts"),
    ("tpu_splat_torch.renderer.render", "replicated",
     "env texture gradient all-reduce (backward)"),
    ("tpu_splat_torch.renderer.render", "shard_rows", "env rays' gradient gather (backward)"),
    ("tpu_splat_torch.renderer.render", "gather_rows", "env sample gather"),
    ("tpu_splat_torch.train.step", "all_mean",
     "DP flat all-reduce: every gradient leaf and 5 loss scalars"),
    ("tpu_splat_torch.train.step", "all_sum_", "DP densify sums all-reduce"),
    ("tpu_splat_torch.train.step", "all_max_", "DP radii and diagnostics all-max"),
)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def implied_bytes(name: str, mesh, args) -> int:
    """The bytes one rank puts into the collective behind `name(mesh, *args)`
    (dist/collectives.py): replicated, all_sum_, all_max_ and all_mean reduce
    their tensors whole; gather_rows sends the rank's rows; shard_rows'
    backward gathers the rank's block of the gradient."""
    if mesh is None or mesh.group is None:
        return 0
    xs = args[0] if name == "all_mean" else args
    total = sum(_nbytes(x) for x in xs)
    return total // mesh.size if name == "shard_rows" else total


class _Recorder:
    """Patches the call sites, the forward kernel's entry and the gloo calls
    of dist/collectives.py for one step."""

    def __init__(self):
        self.sites: dict = {}
        self.instances = 0
        self.pairs = 0
        self.carried = 0

    def _site(self, label, name, fn):
        def wrapped(mesh, *args):
            rec = self.sites.setdefault(label, dict(calls=0, bytes=0))
            rec["calls"] += 1
            rec["bytes"] += implied_bytes(name, mesh, args)
            return fn(mesh, *args)
        return wrapped

    def _blend(self, fn):
        from tpu_splat_torch.kernels.tile_blend import tile_blend_forward_plain

        def counting(feats, starts, counts, org_x, org_y, full_grads=True, packed_feats=False,
                     collect_wmax=True):
            with torch.no_grad():
                _, _, pairs = tile_blend_forward_plain(
                    feats.detach(), starts, counts, org_x, org_y, train_shape=not full_grads,
                    packed_feats=packed_feats, collect_wmax=False, return_pairs=True)
            self.instances += int(counts.sum())
            self.pairs += pairs
            return fn(feats, starts, counts, org_x, org_y, full_grads, packed_feats,
                      collect_wmax)
        return counting

    def _dist(self, real):
        rec = self

        class Carried:
            def __getattr__(self, k):
                return getattr(real, k)

            def all_reduce(self, buf, *a, **kw):
                rec.carried += _nbytes(buf)
                return real.all_reduce(buf, *a, **kw)

            def all_gather(self, parts, x, *a, **kw):
                rec.carried += _nbytes(x)
                return real.all_gather(parts, x, *a, **kw)

        return Carried()

    @contextlib.contextmanager
    def patched(self):
        import tpu_splat_torch.kernels.tile_blend as tb

        saved = []
        for mod_name, name, label in SITES:
            mod = importlib.import_module(mod_name)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, self._site(label, name, getattr(mod, name)))
        saved += [(tb, "blend_kernel", tb.blend_kernel), (collectives, "dist", collectives.dist)]
        tb.blend_kernel = self._blend(tb.blend_kernel)
        collectives.dist = self._dist(collectives.dist)
        try:
            yield self
        finally:
            for mod, name, fn in reversed(saved):
                setattr(mod, name, fn)


def scene(size: int, gaussians: int) -> dict:
    """The JAX tool's load at `size` x `size` with `gaussians` Gaussians:
    numpy arrays for every rank."""
    from tpu_splat_torch.data.synthetic import random_scene
    from tpu_splat_torch.model.convert import state_to_numpy
    from tpu_splat_torch.model.state import init_from_pcd

    rng = np.random.default_rng(0)
    sc = random_scene(gaussians, seed=1, sh_degree=3)
    cap = max(1 << 14, 1 << int(np.ceil(np.log2(gaussians))))
    colors = rng.uniform(0, 1, (gaussians, 3)).astype(np.float32)
    state = init_from_pcd(np.asarray(sc["xyz"]), colors, capacity=cap, cubemap_resolution=16,
                          max_sh_degree=3, device="cpu")
    gt = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    return dict(state=state_to_numpy(state), gt=gt, size=size,
                cfg=dict(max_tiles_per_gaussian=16, max_instances=1 << 17, tile_depth=1024,
                         chunk=16, backend="pallas"))


def _cameras(size: int, n: int):
    from tpu_splat_torch.data.synthetic import orbit_camera

    return [orbit_camera(size, size, radius=4.0, azimuth=0.3 * i, elevation=0.25, device="cpu")
            for i in range(n)]


def run_step(mode: str, n: int, inp: dict, mesh) -> dict:
    """One step of `mode` over `mesh` (None: the unsharded step, one camera
    `n` of the DP batch's), recorded."""
    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.model.convert import state_from_numpy
    from tpu_splat_torch.raster.config import RasterConfig
    from tpu_splat_torch.train.step import TrainState, make_train_step, make_train_step_dp

    opt = OptimizationParams()
    cfg = RasterConfig(**inp["cfg"])
    ts = TrainState.create(state_from_numpy(inp["state"], "cpu"), opt)
    ts.step = opt.init_until_iter  # the deferred-reflection stage: the env pass runs
    bg = torch.zeros(3)
    gt = torch.as_tensor(inp["gt"])
    cams = _cameras(inp["size"], max(n, 1) + 1)
    rec = _Recorder()
    t0 = time.perf_counter()
    with rec.patched():
        if mesh is None:
            make_train_step(opt, cfg, 2.0)(ts, cams[n], gt, bg)
        elif mode == "tiles":
            make_train_step(opt, cfg, 2.0, mesh=mesh)(ts, cams[0], gt, bg)
        else:
            make_train_step_dp(opt, cfg, 2.0, mesh)(ts, cams[:n], [gt] * n, bg)
    wall = time.perf_counter() - t0
    implied = sum(s["bytes"] for s in rec.sites.values())
    if rec.carried != implied:
        raise AssertionError(f"{mode} x{n}: gloo carried {rec.carried} bytes, the sites imply "
                             f"{implied}")
    values = ts.gaussians.param_pytree()
    return dict(instances=rec.instances, pairs=rec.pairs, wall_s=wall,
                sites={k: v for k, v in rec.sites.items() if v["bytes"] or v["calls"]},
                carried=rec.carried,
                replicated=dict(gaussians=ts.gaussians.capacity,
                                loss_pixels=inp["size"] ** 2,
                                adam_values=sum(v.numel() for v in values.values())))


def rank_main(rank: int, n: int, mode: str, inp: dict, threads: int | None) -> dict:
    """One rank of `launch`: the step of `mode` over an n-rank mesh, on
    `threads` intra-op threads (None: launch's share of the cores)."""
    from tpu_splat_torch.dist.mesh import make_mesh

    if threads:
        torch.set_num_threads(threads)
    return dict(run_step(mode, n, inp, make_mesh(n, mode)), rank=rank)


def table(ranks=RANKS, size: int = 192, gaussians: int = 12000,
          threads: int | None = None) -> dict:
    """-> {"unsharded": [per camera], mode: {n: [per rank]}}; `threads`
    caps each rank's intra-op threads."""
    from tpu_splat_torch.dist.mesh import launch

    inp = scene(size, gaussians)
    out = {"unsharded": [run_step("tiles", c, inp, None) for c in range(max(ranks))],
           "size": size, "gaussians": gaussians, "capacity": inp["state"]["xyz"].shape[0]}
    for mode in MODES:
        out[mode] = {}
        for n in ranks:
            out[mode][n] = launch(rank_main, n, args=(n, mode, inp, threads), backend="gloo")
            for r in out[mode][n]:
                print(f"{mode:5s} x{n} rank {r['rank']}: instances {r['instances']} pairs "
                      f"{r['pairs']} sent {r['carried']} B wall {r['wall_s']:.2f} s "
                      "(host copies, not scaling)", flush=True)
    return out


def markdown(res: dict) -> str:
    un = res["unsharded"]
    lines = [
        "# SCALING_torch: the port's multi-rank work table (CPU, gloo)",
        "",
        "Generated by `python -m tpu_splat_torch.tools.scaling_table` (one tile-sharded "
        "and one camera-DP training step a row, ranks started by `dist/mesh.py:launch` "
        f"over gloo on the CPU). Scene: {res['gaussians']} Gaussians of "
        f"random_scene(seed=1, sh_degree=3) in a capacity of {res['capacity']}, "
        f"{res['size']}x{res['size']}, RasterConfig(16, 2^17, 1024, 16), deferred-"
        "reflection stage. SCALING.md is the JAX package's (XLA cost analysis).",
        "",
        "## Work per rank",
        "",
        "Instances: the sum of the tile counts the rank's forward kernel gets. Tested "
        "pairs: the (instance, pixel) alpha tests that kernel makes (early termination "
        "included). Share: of the unsharded step's on the same camera (tile-sharded: "
        "camera 0; DP: the rank's camera). Wall seconds (host clock, the step and the "
        "recorder's extra count of the pairs) are host copies, not scaling: the ranks "
        "share the host's cores.",
        "",
        "| mode | ranks | rank | instances | tested pairs | share of unsharded | wall s |",
        "|---|---|---|---|---|---|---|",
    ]
    for mode in MODES:
        for n, ranks in res[mode].items():
            for r in ranks:
                base = un[0] if mode == "tiles" else un[r["rank"]]
                lines.append(
                    f"| {mode} | {n} | {r['rank']} | {r['instances']} | {r['pairs']} | "
                    f"{r['instances'] / max(base['instances'], 1):.3f} / "
                    f"{r['pairs'] / max(base['pairs'], 1):.3f} | {r['wall_s']:.2f} |")
    lines.append(f"| unsharded | 1 | camera 0 | {un[0]['instances']} | {un[0]['pairs']} | 1 | "
                 f"{un[0]['wall_s']:.2f} |")
    lines += [
        "",
        "## Collectives per step (bytes a rank puts in)",
        "",
        "By call site of `dist/collectives.py`, as the tensors there imply them; the "
        "gloo calls' own byte count equals their sum on every rank (checked). One rank "
        "still runs each collective (a one-rank group).",
        "",
        "| mode | ranks | collective | calls | bytes a rank |",
        "|---|---|---|---|---|",
    ]
    for mode in MODES:
        for n, ranks in res[mode].items():
            for label, s in ranks[0]["sites"].items():
                lines.append(f"| {mode} | {n} | {label} | {s['calls']} | {s['bytes']} |")
    rep = un[0]["replicated"]
    lines += [
        "",
        "## What stays replicated",
        "",
        "Every rank holds the whole model and repeats in full, at every rank count: the "
        f"preprocess of all {rep['gaussians']} Gaussians (rows of the capacity), the "
        f"loss and normal terms on all {rep['loss_pixels']} pixels of the gathered "
        f"frame, Adam on all {rep['adam_values']} parameter values, and the densify "
        "statistics. The tile-sharded step splits binning, packing, both blend kernels, "
        "the regroup and the cubemap sample's pixel rows; the DP step splits nothing "
        "within a camera and steps one camera a rank.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=list(RANKS))
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--gaussians", type=int, default=12000)
    ap.add_argument("--out", default="SCALING_torch.md")
    args = ap.parse_args(argv)
    res = table(tuple(args.ranks), args.size, args.gaussians)
    if args.out:
        with open(args.out, "w") as f:
            f.write(markdown(res))
        print(f"wrote {os.path.abspath(args.out)}", flush=True)
    return res


if __name__ == "__main__":
    main()
