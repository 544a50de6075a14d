"""Driver `viewer`: the frame that `tpu_splat_torch/scripts/view.py` serves,
without the socket. One viewer flies the mix's orbit and asks for a frame
every 1 / `rate_hz` seconds (`rate_hz` 0: as soon as the last frame has
arrived, a closed loop); the server answers one request at a time, so a
request due while the last frame is still on its way is sent when that frame
has arrived. Each request: the viewer's camera dict -> `viewer_camera` ->
`render_fast(collect_weights=False)` -> `render_net_image(out, "RGB")` ->
`encode_u8` -> the bytes in host memory. A frame's latency runs from the
moment its request was due to the moment its bytes are on the host.

The raster caps are view.py's `VIEW_CAPS` except `max_instances`, which is
probed over the orbit (view.py's 2^21 drops instances of these clouds).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from splatbench import counts, program, scene
from splatbench.counts import step as step_counts
from splatbench.reference import splat
from splatbench.trace import HostSpans, traced_windows


class Server:
    def __init__(self, st, cfg, bg, spans, sync_encode: bool):
        self.st, self.cfg, self.bg, self.spans = st, cfg, bg, spans
        self.sync_encode = sync_encode

    def __call__(self, req: dict) -> np.ndarray:
        from tpu_splat_torch.renderer import render_fast
        from tpu_splat_torch.viewer.network_gui import encode_u8, render_net_image, viewer_camera

        with self.spans("frame"):
            cam = viewer_camera(req, self.st.device)
            out = render_fast(self.st, cam, self.cfg, self.bg, collect_weights=False)
        if self.sync_encode:
            torch.cuda.synchronize()  # traced runs: the span below holds no render
        with self.spans("encode_readback"):
            u8 = encode_u8(render_net_image(out, "RGB"))
            return u8.cpu().numpy()


def run(ctx) -> dict:
    from tpu_splat_torch.viewer.network_gui import viewer_camera

    conf, mix, dev = ctx.config, ctx.traffic, ctx.device
    H, W = conf["image"]["height"], conf["image"]["width"]
    cloud = scene.cloud(conf["scene"], ctx.seed, dev)
    n = cloud["xyz"].shape[0]
    p0 = {k: v.detach().cpu() for k, v in cloud.items()}
    st = program.state(cloud, n)
    del cloud
    reqs = scene.viewer_requests(mix, ctx.seed, H, W)
    cfg = program.view_config(dict(mix["view_caps"], max_instances=program.PROBE_MAX_INSTANCES))
    probe = [program.probe_instances(st, viewer_camera(r, dev), cfg)[0]
             for r in reqs[::mix["probe_stride"]]]
    cfg = dataclasses.replace(cfg, max_instances=program.covering_capacity(max(probe)))
    bg = torch.tensor(conf["background"], dtype=torch.float32, device=dev)
    spans = HostSpans(False)
    serve = Server(st, cfg, bg, spans, sync_encode=False)
    for r in reqs[: mix["warmup_frames"]]:
        serve(r)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    # the frames the reference redraws, drawn from the seed among the first
    # the window serves
    rng = np.random.default_rng(int(ctx.seed) + 2)
    within = mix["trace_frames"] if ctx.trace else mix["check_within"]
    keep = set(rng.choice(within, mix["check_frames"], replace=False).tolist())

    result = dict(setup_s=setup_s, sizes=dict(probed_instances=max(probe),
                                             max_instances=cfg.max_instances))
    kept = {}
    if not ctx.trace:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        lat, k = [], 0
        closed = mix["rate_hz"] <= 0  # the next request as soon as a frame is in
        period = 0.0 if closed else 1.0 / mix["rate_hz"]
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            due = now if closed else t0 + k * period
            if due > t0 + ctx.seconds:
                break
            if now < due:
                time.sleep(due - now)
            frame = serve(reqs[(mix["warmup_frames"] + k) % len(reqs)])
            lat.append(time.perf_counter() - due)
            if k in keep:
                kept[k] = frame
            k += 1
        window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        result.update(steps=k, window_s=window, metrics=dict(
            serve_frame_ms_p95=(float(np.percentile(np.asarray(lat) * 1e3, 95)), "ms"),
            serve_frames_per_s=(k / window, "frames/s"),
            setup_s=(setup_s, "s")))
        result["memory_peak_bytes"] = max(peak, setup_peak)
        result["latency_ms"] = dict(median=float(np.median(lat) * 1e3),
                                    p95=float(np.percentile(lat, 95) * 1e3),
                                    max=float(np.max(lat) * 1e3), frames=k,
                                    late_share=float(np.mean(np.asarray(lat) > period))
                                    if not closed else None)
    else:
        result.update(_traced_window(ctx, serve, reqs, p0, n, H, W, keep, kept))
        result["memory_peak_bytes"] = max(setup_peak, result["memory_peak_bytes"])
    result["attempted"] = result["steps"]
    result["failed"] = 0
    del serve, st
    program.free_cached()
    result["checks"] = _check(ctx, conf, mix, p0, reqs, kept, bg)
    return result


def _traced_window(ctx, serve, reqs, p0, n, H, W, keep, kept) -> dict:
    mix, dev = ctx.traffic, ctx.device
    k = mix["trace_frames"]

    def body(i):
        # the spans' window synchronises before the encode, so that its span
        # holds no render; the profiled window does not
        serve.sync_encode = dev.type == "cuda" and i < k
        frame = serve(reqs[(mix["warmup_frames"] + i) % len(reqs)])
        if i in keep:
            kept[i] = frame

    t = traced_windows(k, body, serve.spans, dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    # operations of the spans' frames, from the reference's blend of each
    p = {key: v.to(dev) for key, v in p0.items()}
    prec = splat.Precision(**ctx.config["precision"], **mix["packing"])
    tiles = ((H + 15) // 16) * ((W + 15) // 16)
    c = dict(fwd_ops=0.0, fwd_bytes=0.0, frame_ops=0.0)
    for i in range(0, k, mix["count_stride"]):
        cam = splat.viewer_camera(reqs[(mix["warmup_frames"] + i) % len(reqs)], dev)
        _, info = splat.frame(p, cam, torch.zeros(3, device=dev), prec, splat.Binning(),
                              want_counts=True)
        pairs = counts.blend_pairs(info["stats"])
        fo, fb = counts.blend_forward(pairs, tiles, packed=False)
        w = min(mix["count_stride"], k - i)
        c["fwd_ops"] += w * fo
        c["fwd_bytes"] += w * fb
        c["frame_ops"] += w * step_counts.frame_ops(pairs, tiles, n, H * W)
    t.counts = c
    del p
    return dict(steps=2 * k, window_s=t.window_s, trace=t, memory_peak_bytes=peak)


def _check(ctx, conf, mix, p0, reqs, kept, bg) -> list:
    """The reference renders the kept frames' requests; -> the worst share of
    pixel channels more than one level off, and the worst mean level
    difference, over the kept frames."""
    dev = ctx.device
    p = {k: v.to(dev) for k, v in p0.items()}
    prec = splat.Precision(**conf["precision"], **mix["packing"])
    off, mean = 0.0, 0.0
    for k, got in sorted(kept.items()):
        cam = splat.viewer_camera(reqs[(mix["warmup_frames"] + k) % len(reqs)], dev)
        img, _ = splat.frame(p, cam, bg, prec, splat.Binning())
        want = splat.encode_u8(img).cpu().numpy().astype(np.int16)
        d = np.abs(got.astype(np.int16) - want)
        off = max(off, float(np.mean(d > 1)))
        mean = max(mean, float(np.mean(d)))
    if not kept:
        off = mean = float("inf")
    lim = ctx.limits
    return [("frame_off_share", off, lim["frame_off_share"], f"{len(kept)} frames"),
            ("frame_mean_levels", mean, lim["frame_mean_levels"], "")]
