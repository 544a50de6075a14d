"""Readings of the controls of `correct` for a volumetric training cell
(driver `train_vol`), at the cell's own size.

    python3 -m splatbench.tools.control_vol --workload train-vol-synth1m-1080p --seeds 1 2 3 [--out F]

As `control.py` does for the surfel cells: for each seed the plain
volumetric reference is put in the program's place and computed twice
more, on TF32 operands in every matrix product and convolution, and with
the planted fault of a loss over half the rows; each is compared with the
reference at the stated precision by the cell's own numbers. A control is
meant to read above the cell's limits.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from splatbench import run, scene
from splatbench.drivers import train as train_driver
from splatbench.drivers import train_vol
from splatbench.reference import splat
from splatbench.reference import train as ref_train
from splatbench.reference import volumetric as ref_vol
from splatbench.tools.control import first_views


def train_readings(conf, mix, limits, seed, dev) -> dict:
    H, W = conf["image"]["height"], conf["image"]["width"]
    cloud = train_vol.cloud(conf["scene"], seed, dev)
    n = cloud["xyz"].shape[0]
    views = scene.train_views(mix, seed, H, W)
    extent, _ = scene.scene_radius(views)
    gts = scene.ground_truth(seed, len(views), H, W, dev)
    p = dict(cloud, **ref_train.isp_init(len(views), dev))
    p["alive"] = torch.ones(n, dtype=torch.bool, device=dev)
    vs = first_views(seed, len(views), mix["reference_steps"])
    steps = [(splat.camera(*views[v], H, W, dev), gts[v], v) for v in vs]
    base = dict(conf["precision"], **mix["packing"])
    go = lambda prec, fault="": ref_vol.run_steps(p, steps, torch.zeros(3, device=dev),
                                                  conf["training"], extent, mix["start_step"],
                                                  prec, fault)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    _, cell, conf, mix, limits = run.load_cell(a.workload)
    if mix["driver"] != "train_vol":
        raise SystemExit(f"{a.workload} is not a volumetric training cell: use control.py")
    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        r = dict(seed=seed, readings=train_readings(conf, mix, limits, seed, dev),
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
