"""Driver `train`: the train CLI's loop body (tpu_splat_torch/scripts/train.py,
one device, `--disable_viewer`, nothing written to disk) from a state whose
step is `start_step`, on the mix's views and the seed's ground truth.

Set-up probes the instance capacity over every view, lets the loop's own
growth rule (`check_growth`) settle the capacities, builds the step and
runs `warmup_steps` iterations of the loop body; the reference follows the
first `reference_steps` of them. The window then runs the loop body until
`--seconds` have passed on the host clock and synchronises.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np
import torch

from splatbench import counts, program, scene
from splatbench.counts import step as step_counts
from splatbench.reference import splat
from splatbench.reference import train as ref_train
from splatbench.trace import HostSpans, traced_windows

LEAVES = ref_train.LEAVES


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


class Loop:
    """The loop body of the train CLI, one iteration per call."""

    def __init__(self, ts, step_fn, cfg, cams, gts, bg, opt, extent, mean, seed, spans):
        from tpu_splat_torch.train.loop import EventLog

        self.ts, self.step_fn, self.cfg = ts, step_fn, cfg
        self.cams, self.gts, self.bg, self.opt = cams, gts, bg, opt
        self.extent, self.mean = extent, mean
        self.order, self.rng = [], random.Random(int(seed))
        self.ema, self.log, self.iteration = 0.0, EventLog(), ts.step
        self.spans, self.failed, self.grew = spans, 0, 0
        self.views_used = []

    def __call__(self):
        from tpu_splat_torch.train.grow import check_growth
        from tpu_splat_torch.train.loop import is_scene_frozen, run_scheduled_events

        sp = self.spans
        self.iteration += 1
        it = self.iteration
        with sp("loop_host"):
            frozen = is_scene_frozen(it, self.opt, True)
            if not self.order:
                self.order = list(range(len(self.cams)))
                self.rng.shuffle(self.order)
            v = self.order.pop()
            self.views_used.append(v)
            gt = self.gts[v]
        with sp("step"):
            self.ts, aux = self.step_fn(self.ts, self.cams[v], gt, self.bg, gt_alpha=None,
                                        frozen=frozen, frame_idx=v)
        with sp("loop_host"):
            self.ema = 0.4 * aux.loss + 0.6 * self.ema
            if it % 100 == 0:
                loss_now = float(aux.loss)
                # the CLI's progress line: every value read to the host
                _ = (f"[{it}] loss {float(self.ema):.5f} psnr {float(aux.psnr):.2f} "
                     f"pts {int(aux.n_alive)} inst {int(aux.num_instances)} "
                     f"maxtile {int(aux.max_tile_count)}")
                if not math.isfinite(loss_now):
                    self.failed += 1
            prev = self.log.overflowed
            self.ts = run_scheduled_events(self.ts, it, self.opt, cameras_extent=self.extent,
                                           cameras_mean=self.mean, scene_frozen=frozen,
                                           log=self.log)
            if self.log.overflowed != prev or it % 100 == 0:
                n_inst = int(aux.num_instances)
                dec = check_growth(self.ts, self.cfg, n_alive=int(aux.n_alive),
                                   num_instances=n_inst, max_tile_count=int(aux.max_tile_count),
                                   densify_overflow=self.log.overflowed - prev,
                                   pad_overflow=int(aux.pad_overflow))
                if dec.grew:
                    self.grew += 1
                    self.ts, self.cfg = dec.ts, dec.cfg
                    self.step_fn = self.rebuild(self.cfg)
                elif n_inst >= self.cfg.max_instances:
                    self.failed += 1  # the forward dropped instances
            if it % 100 == 0:
                # the reporter's scalars
                _ = (float(aux.loss), float(aux.l1), float(aux.normal_loss), int(aux.n_alive))
        return aux


def run(ctx) -> dict:
    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.isp.ppisp import ISPConfig
    from tpu_splat_torch.train.grow import check_growth
    from tpu_splat_torch.train.step import TrainState, make_train_step

    conf, mix, dev = ctx.config, ctx.traffic, ctx.device
    H, W = conf["image"]["height"], conf["image"]["width"]
    cloud = scene.cloud(conf["scene"], ctx.seed, dev)
    n = cloud["xyz"].shape[0]
    views = scene.train_views(mix, ctx.seed, H, W)
    extent, mean = scene.scene_radius(views)
    gts = scene.ground_truth(ctx.seed, len(views), H, W, dev)
    p0 = {k: v.detach().cpu() for k, v in cloud.items()}

    opt = OptimizationParams()
    st = program.state(cloud, conf["scene"]["capacity"])
    del cloud
    cams = [program.camera(v, H, W, dev) for v in views]
    cfg = program.raster_config(conf["raster"], max_instances=program.PROBE_MAX_INSTANCES,
                                tight_culling=mix["tight_culling"])
    probes = [program.probe_instances(st, c, cfg) for c in cams]
    n_inst = max(p[0] for p in probes)
    cfg = dataclasses.replace(cfg, max_instances=program.covering_capacity(n_inst))
    ts = TrainState.create(st, opt, num_frames=len(views))
    ts.step = mix["start_step"]
    # what the loop's first growth check would decide, decided before the window
    dec = check_growth(ts, cfg, n_alive=n, num_instances=n_inst, max_tile_count=0,
                       densify_overflow=0, pad_overflow=max(p[1] for p in probes))
    ts, cfg = dec.ts, dec.cfg
    isp_cfg = ISPConfig(controller_activation_ratio=(opt.iterations - 5000) / opt.iterations)

    def build(c):
        return make_train_step(opt, c, spatial_lr_scale=extent,
                               use_env_scope=opt.use_env_scope,
                               env_scope_center=opt.env_scope_center,
                               env_scope_radius=opt.env_scope_radius, isp_cfg=isp_cfg)

    bg = torch.tensor(conf["background"], dtype=torch.float32, device=dev)
    spans = HostSpans(False)
    loop = Loop(ts, build(cfg), cfg, cams, gts, bg, opt, extent, mean, ctx.seed, spans)
    loop.rebuild = build
    loop.views = views

    # warm-up: the reference follows the first steps of the same loop
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
        result.update(_traced_window(ctx, loop, H, W, n))
        result["memory_peak_bytes"] = max(setup_peak, result["memory_peak_bytes"])
    result["attempted"] = result["steps"]
    result["failed"] = loop.failed + loop.grew

    # the program's state is freed before the reference runs
    del loop, ts, st, dec, aux
    program.free_cached()
    result["checks"] = _check(ctx, conf, mix, p0, views, gts, ref_views, extent, bg, got, n)
    return result


def _traced_window(ctx, loop, H, W, n) -> dict:
    first = len(loop.views_used)
    t = traced_windows(ctx.traffic["trace_steps"], lambda i: loop(), loop.spans, ctx.device)
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    t.counts = _window_counts(ctx, loop, loop.views_used[first:first + t.steps], H, W, n)
    return dict(steps=2 * t.steps, window_s=t.window_s, trace=t, memory_peak_bytes=peak)


def _window_counts(ctx, loop, used, H, W, n) -> dict:
    """Operations and bytes of the traced steps, from the reference's blend
    of each view at the state the window ended with."""
    conf, mix, dev = ctx.config, ctx.traffic, ctx.device
    g = loop.ts.gaussians
    p = {k: v[:n].detach() if k in ref_train.GAUSSIAN_LEAVES else v.detach()
         for k, v in program.leaves(g).items()}
    binning = splat.Binning(opacity_rect=True, tight=mix["tight_culling"])
    prec = splat.Precision(**conf["precision"], **mix["packing"])
    tiles = ((H + 15) // 16) * ((W + 15) // 16)
    out = dict(fwd_ops=0.0, fwd_bytes=0.0, bwd_ops=0.0, bwd_bytes=0.0, step_ops=0.0)
    per_view = {}
    for v in used:
        if v not in per_view:
            cam = splat.camera(*loop.views[v], H, W, dev)
            _, info = splat.frame(p, cam, torch.zeros(3, device=dev), prec, binning,
                                  want_counts=True)
            per_view[v] = counts.blend_pairs(info["stats"])
        pairs = per_view[v]
        fo, fb = counts.blend_forward(pairs, tiles, packed=True)
        bo, bb = counts.blend_backward(pairs, tiles, packed=True)
        out["fwd_ops"] += fo
        out["fwd_bytes"] += fb
        out["bwd_ops"] += bo
        out["bwd_bytes"] += bb
        out["step_ops"] += step_counts.train_step_ops(
            pairs, tiles, n, int(g.env.texture.numel()), H * W)
    return out


def _check(ctx, conf, mix, p0, views, gts, ref_views, extent, bg, got, n) -> list:
    """The reference follows the program's first steps from the same leaves,
    views, ground truth and frames; -> [(name, reading, limit, worst leaf)]."""
    dev = ctx.device
    H, W = conf["image"]["height"], conf["image"]["width"]
    p = {k: v.to(dev) for k, v in p0.items()}
    p.update(ref_train.isp_init(len(views), dev))
    p["alive"] = torch.ones(n, dtype=torch.bool, device=dev)
    steps = [(splat.camera(*views[v], H, W, dev), gts[v], v) for v in ref_views]
    prec = splat.Precision(**conf["precision"], **mix["packing"])
    binning = splat.Binning(opacity_rect=True, tight=mix["tight_culling"])
    ref = ref_train.run_steps(p, steps, bg, conf["training"], extent, mix["start_step"], prec,
                              binning)
    return compare_steps(got, ref, p, ctx.limits)


def compare_steps(got: dict, ref: dict, p0: dict, limits: dict) -> list:
    """The worst relative gap of the steps' losses; the median over the
    moving leaves of the relative gap of the first gradient's per-leaf
    norms; and the worst relative gap of the per-leaf norms of the change
    over the steps. A norm gap is |program - reference| over the larger of
    the reference's norm of that leaf and the median leaf's. A leaf moves
    where its reference gradient reaches a thousandth of the median leaf's
    at some step; the others are left out (Adam moves them by round-off
    alone). The first gradient is compared by its median leaf because the
    norms of xyz and rotation are carried by a few near-singular surfels
    whose rows part between any two float32 evaluations; their worst leaf
    is reported beside it, not compared."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))

    def gaps(prog: dict, refn: dict, keys):
        med = float(np.median([refn[k] for k in refn]))
        return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30) for k in keys}

    def moving(norms: dict):
        med = float(np.median(list(norms.values())))
        return {k for k in LEAVES if norms[k] >= 1e-3 * med}

    g = gaps(got["grad_norms"], ref["grad_norms"][0], sorted(moving(ref["grad_norms"][0])))
    g_med = float(np.median(list(g.values())))
    g_worst = max(g, key=g.get)
    moved = set().union(*(moving(s) for s in ref["grad_norms"]))
    ch_ref = {k: _norm(ref["params"][k] - p0[k]) for k in LEAVES}
    c = gaps(got["change_norms"], ch_ref, sorted(moved))
    c_worst = max(c, key=c.get)
    return [("loss", loss_gap, limits["loss"], ""),
            ("grad_norm_median", g_med, limits["grad_norm_median"],
             f"worst leaf {g_worst} {g[g_worst]:.3g}, not compared"),
            ("change_norm", c[c_worst], limits["change_norm"], c_worst)]
