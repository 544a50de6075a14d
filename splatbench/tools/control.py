"""Readings of the controls of `correct`, at a cell's own size.

    python3 -m splatbench.tools.control --workload <cell> --seeds 1 2 3 [--out F]

For each seed the plain reference is put in the program's place and
computed twice more: in the precision below the configuration's (TF32
operands in every matrix product and convolution) and, for a training cell,
with the planted fault of a loss taken over half the rows. Each is compared
with the reference at the stated precision by the cell's own numbers; a
control is meant to read above the cell's limits.
"""
from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from splatbench import run, scene
from splatbench.drivers import train as train_driver
from splatbench.reference import splat
from splatbench.reference import train as ref_train


def first_views(seed: int, n_views: int, k: int) -> list:
    """The first k views of the train loop's epoch shuffle."""
    order = list(range(n_views))
    random.Random(int(seed)).shuffle(order)
    return [order.pop() for _ in range(k)]


def train_readings(conf, mix, limits, seed, dev) -> dict:
    H, W = conf["image"]["height"], conf["image"]["width"]
    cloud = scene.cloud(conf["scene"], seed, dev)
    n = cloud["xyz"].shape[0]
    views = scene.train_views(mix, seed, H, W)
    extent, _ = scene.scene_radius(views)
    gts = scene.ground_truth(seed, len(views), H, W, dev)
    p = dict(cloud, **ref_train.isp_init(len(views), dev))
    p["alive"] = torch.ones(n, dtype=torch.bool, device=dev)
    vs = first_views(seed, len(views), mix["reference_steps"])
    steps = [(splat.camera(*views[v], H, W, dev), gts[v], v) for v in vs]
    binning = splat.Binning(opacity_rect=True, tight=mix["tight_culling"])
    base = dict(conf["precision"], **mix["packing"])
    go = lambda prec, fault="": ref_train.run_steps(p, steps, torch.zeros(3, device=dev),
                                                    conf["training"], extent,
                                                    mix["start_step"], prec, binning, fault)
    clean = go(splat.Precision(**base))
    out = {}
    for name, prec, fault in (("tf32", splat.Precision(**dict(base, tf32=True)), ""),
                              ("half_batch", splat.Precision(**base), "half_batch")):
        r = go(prec, fault)
        got = dict(losses=r["losses"], grad_norms=r["grad_norms"][0],
                   change_norms={k: float(torch.linalg.vector_norm((r["params"][k] - p[k])
                                                                   .double()))
                                 for k in ref_train.LEAVES})
        out[name] = {c[0]: [c[1], c[3]] for c in
                     train_driver.compare_steps(got, clean, p, limits)}
        del r
    return out


def serve_readings(conf, mix, limits, seed, dev) -> dict:
    H, W = conf["image"]["height"], conf["image"]["width"]
    p = scene.cloud(conf["scene"], seed, dev)
    reqs = scene.viewer_requests(mix, seed, H, W)
    rng = np.random.default_rng(int(seed) + 2)
    keep = rng.choice(mix["check_within"], mix["check_frames"], replace=False).tolist()
    base = dict(conf["precision"], **mix["packing"])
    bg = torch.tensor(conf["background"], dtype=torch.float32, device=dev)
    off = mean = 0.0
    for k in keep:
        cam = splat.viewer_camera(reqs[(mix["warmup_frames"] + k) % len(reqs)], dev)
        want = splat.encode_u8(splat.frame(p, cam, bg, splat.Precision(**base),
                                           splat.Binning())[0]).cpu().numpy().astype(np.int16)
        got = splat.encode_u8(splat.frame(p, cam, bg, splat.Precision(**dict(base, tf32=True)),
                                          splat.Binning())[0]).cpu().numpy().astype(np.int16)
        d = np.abs(got - want)
        off, mean = max(off, float(np.mean(d > 1))), max(mean, float(np.mean(d)))
    return {"tf32": {"frame_off_share": [off, ""], "frame_mean_levels": [mean, ""]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    _, cell, conf, mix, limits = run.load_cell(a.workload)
    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        fn = train_readings if mix["driver"] == "train" else serve_readings
        r = dict(seed=seed, readings=fn(conf, mix, limits, seed, dev),
                 seconds=time.perf_counter() - t0)
        rows.append(r)
        print(json.dumps(r), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(workload=a.workload, card=run.card_line(), rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
