"""Driver `train_vol`: the train CLI's loop body (driver `train`'s `Loop`) on
a volumetric 3DGS-DR state: three scale axes, so the program's renderer
takes its volumetric family (EWA preprocess, shortest-axis normals).

The cloud is the configuration's synthetic cloud (`scene.py`, the bench's
distributions) with a third log-scale at the mean of the two plus
log(`thin_axis_ratio`). Set-up refuses, within seconds, a program whose
renderer has no volumetric family (it would run the surfel preprocess on
three axes); then probes the instance capacity over every view with the
program's volumetric preprocess and binning, lets the loop's growth rule
settle the capacities and runs the warm-up, as driver `train` does. The
plain reference (`reference/volumetric.py`) follows the first
`reference_steps`.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from splatbench import counts, program, scene
from splatbench.counts import step_vol
from splatbench.drivers.train import LEAVES, Loop, _norm, compare_steps
from splatbench.reference import splat
from splatbench.reference import train as ref_train
from splatbench.reference import volumetric as ref_vol
from splatbench.trace import HostSpans, traced_windows


def require_volumetric_program():
    """Raise unless the program's renderer takes a three-axis state."""
    import importlib

    from tpu_splat_torch.model.state import GaussianState

    render_mod = importlib.import_module("tpu_splat_torch.renderer.render")
    if not (hasattr(render_mod, "shortest_axis_normals")
            and hasattr(GaussianState, "volumetric")):
        raise SystemExit("splatbench: the program's renderer has no volumetric family "
                         "(no GaussianState.volumetric, no shortest_axis_normals): a "
                         "three-axis state would run the surfel preprocess")


def require_no_antialiasing(conf: dict):
    """Raise if the configuration asks for antialiasing: the volumetric
    family rasterizes without it, as the vendored rasterizer's default."""
    if conf.get("antialiasing", False):
        raise SystemExit("splatbench: the volumetric family renders without antialiasing, "
                         "and the configuration asks for it")


def cloud(conf_scene: dict, seed: int, device) -> dict:
    """The synthetic cloud with its third, thin axis."""
    c = scene.cloud(conf_scene, seed, device)
    s = c["scaling"]
    c["scaling"] = torch.cat(
        [s, s.mean(1, keepdim=True) + math.log(conf_scene["thin_axis_ratio"])], 1)
    return c


def probe_instances(st, cam, cfg) -> tuple[int, int]:
    """(instances, pads past the pad budget) the program's volumetric
    preprocess and binning emit for this view at a capacity that drops
    nothing (`program.probe_instances`, which is the surfels')."""
    from tpu_splat_torch.raster.binning import bin_gaussians
    from tpu_splat_torch.raster.volumetric import preprocess_volumetric

    probe = dataclasses.replace(cfg, max_instances=program.PROBE_MAX_INSTANCES)
    with torch.no_grad():
        zeros = torch.zeros((st.capacity, 3), device=st.device)
        p, _ = preprocess_volumetric(st.xyz, st.get_scaling(), st.rotation, zeros,
                                     cam.world_view, cam.full_proj, cam.camera_center,
                                     cam.height, cam.width, cam.tanfovx, cam.tanfovy,
                                     colors=zeros)
        valid = p.valid & st.alive
        p = p._replace(valid=valid, tiles_touched=torch.where(
            valid, p.tiles_touched, torch.zeros_like(p.tiles_touched)))
        b = bin_gaussians(p, cam.height, cam.width, probe, aligned=True)
        return int(b.num_instances), int(b.pad_overflow)


def run(ctx) -> dict:
    require_volumetric_program()
    require_no_antialiasing(ctx.config)
    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.isp.ppisp import ISPConfig
    from tpu_splat_torch.train.grow import check_growth
    from tpu_splat_torch.train.step import TrainState, make_train_step

    conf, mix, dev = ctx.config, ctx.traffic, ctx.device
    H, W = conf["image"]["height"], conf["image"]["width"]
    c = cloud(conf["scene"], ctx.seed, dev)
    n = c["xyz"].shape[0]
    views = scene.train_views(mix, ctx.seed, H, W)
    extent, mean = scene.scene_radius(views)
    gts = scene.ground_truth(ctx.seed, len(views), H, W, dev)
    p0 = {k: v.detach().cpu() for k, v in c.items()}

    opt = OptimizationParams()
    st = program.state(c, conf["scene"]["capacity"])
    del c
    cams = [program.camera(v, H, W, dev) for v in views]
    cfg = program.raster_config(conf["raster"], max_instances=program.PROBE_MAX_INSTANCES,
                                tight_culling=mix["tight_culling"])
    probes = [probe_instances(st, cam, cfg) for cam in cams]
    n_inst = max(p[0] for p in probes)
    cfg = dataclasses.replace(cfg, max_instances=program.covering_capacity(n_inst))
    ts = TrainState.create(st, opt, num_frames=len(views))
    ts.step = mix["start_step"]
    dec = check_growth(ts, cfg, n_alive=n, num_instances=n_inst, max_tile_count=0,
                       densify_overflow=0, pad_overflow=max(p[1] for p in probes))
    ts, cfg = dec.ts, dec.cfg
    isp_cfg = ISPConfig(controller_activation_ratio=(opt.iterations - 5000) / opt.iterations)

    def build(cf):
        return make_train_step(opt, cf, spatial_lr_scale=extent,
                               use_env_scope=opt.use_env_scope,
                               env_scope_center=opt.env_scope_center,
                               env_scope_radius=opt.env_scope_radius, isp_cfg=isp_cfg)

    bg = torch.tensor(conf["background"], dtype=torch.float32, device=dev)
    spans = HostSpans(False)
    loop = Loop(ts, build(cfg), cfg, cams, gts, bg, opt, extent, mean, ctx.seed, spans)
    loop.rebuild = build
    loop.views = views

    n_ref = mix["reference_steps"]
    got = dict(losses=[])
    for k in range(mix["warmup_steps"]):
        aux = loop()
        if k < n_ref:
            got["losses"].append(float(aux.loss))
        if k == 0:
            g1 = program.first_gradients(loop.ts)
            got["grad_norms"] = {key: _norm(g1[key]) for key in LEAVES}
            del g1
        if k == n_ref - 1:
            now = program.leaves(loop.ts.gaussians, loop.ts.isp)
            init = dict(p0, **ref_train.isp_init(len(views), "cpu"))
            got["change_norms"] = {
                key: _norm(now[key][:n] - init[key].to(dev)) if key in ref_train.GAUSSIAN_LEAVES
                else _norm(now[key] - init[key].to(dev)) for key in LEAVES}
            del now
    ref_views = loop.views_used[:n_ref]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    result = dict(setup_s=setup_s, sizes=dict(
        probed_instances=n_inst, max_instances=loop.cfg.max_instances,
        rows=loop.ts.gaussians.capacity, pad_overflow=max(p[1] for p in probes)))
    if not ctx.trace:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        steps = 0
        t0 = time.perf_counter()
        while True:
            loop()
            steps += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        result.update(steps=steps, window_s=window, metrics=dict(
            train_px_per_s=(H * W * steps / window, "px/s"),
            train_peak_gib=(peak / 2 ** 30, "GiB"),
            setup_s=(setup_s, "s")))
        result["memory_peak_bytes"] = max(peak, setup_peak)
    else:
        first = len(loop.views_used)
        t = traced_windows(mix["trace_steps"], lambda i: loop(), loop.spans, dev)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        t.counts = window_counts(ctx, loop, loop.views_used[first:first + t.steps], H, W, n)
        result.update(steps=2 * t.steps, window_s=t.window_s, trace=t,
                      memory_peak_bytes=max(setup_peak, peak))
    result["attempted"] = result["steps"]
    result["failed"] = loop.failed + loop.grew

    del loop, ts, st, dec, aux
    program.free_cached()
    result["checks"] = check(ctx, conf, mix, p0, views, gts, ref_views, extent, bg, got, n)
    return result


def window_counts(ctx, loop, used, H, W, n) -> dict:
    """Operations and bytes of the traced steps, from the reference's blend
    of each view at the state the window ended with."""
    conf, mix, dev = ctx.config, ctx.traffic, ctx.device
    g = loop.ts.gaussians
    p = {k: v[:n].detach() if k in ref_train.GAUSSIAN_LEAVES else v.detach()
         for k, v in program.leaves(g).items()}
    prec = splat.Precision(**conf["precision"], **mix["packing"])
    tiles = ((H + 15) // 16) * ((W + 15) // 16)
    out = dict(fwd_ops=0.0, fwd_bytes=0.0, bwd_ops=0.0, bwd_bytes=0.0, step_ops=0.0)
    per_view = {}
    for v in used:
        if v not in per_view:
            cam = splat.camera(*loop.views[v], H, W, dev)
            _, info = ref_vol.frame(p, cam, torch.zeros(3, device=dev), prec, want_counts=True)
            per_view[v] = counts.blend_pairs(info["stats"])
            del info
        pairs = per_view[v]
        fo, fb = counts.blend_forward(pairs, tiles, packed=True)
        bo, bb = counts.blend_backward(pairs, tiles, packed=True)
        out["fwd_ops"] += fo
        out["fwd_bytes"] += fb
        out["bwd_ops"] += bo
        out["bwd_bytes"] += bb
        out["step_ops"] += step_vol.train_step_ops(
            pairs, tiles, n, int(g.env.texture.numel()), H * W)
    return out


def check(ctx, conf, mix, p0, views, gts, ref_views, extent, bg, got, n) -> list:
    """The reference follows the program's first steps from the same leaves,
    views, ground truth and frames; -> [(name, reading, limit, worst leaf)]."""
    dev = ctx.device
    H, W = conf["image"]["height"], conf["image"]["width"]
    p = {k: v.to(dev) for k, v in p0.items()}
    p.update(ref_train.isp_init(len(views), dev))
    p["alive"] = torch.ones(n, dtype=torch.bool, device=dev)
    steps = [(splat.camera(*views[v], H, W, dev), gts[v], v) for v in ref_views]
    prec = splat.Precision(**conf["precision"], **mix["packing"])
    ref = ref_vol.run_steps(p, steps, bg, conf["training"], extent, mix["start_step"], prec)
    return compare_steps(got, ref, p, ctx.limits)
