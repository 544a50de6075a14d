#!/usr/bin/env python3
"""Serving frame time of the port in two source trees, alternated on one card.

    python3 serve_ab.py BASE_TREE [CHANGE_TREE]

CHANGE_TREE defaults to the directory of this script. BASE_TREE is another
checkout of the repository (for instance `git archive` of an earlier commit
unpacked under `tpu_splat_torch/_build/`, which git ignores). The trees run
in the order base, change, change, base, each in a process of its own that
puts its tree first on sys.path, builds that tree's kernels, draws the bench
cloud with that tree's `chip_smoke.build_state` (1M surfels, 64^2 cubemap)
and serves `render_fast` with the production switches at 1088x1920: one
warm-up frame, REPS rounds of the four bench views (host clock around work
that ends in torch.cuda.synchronize()), then STAGE_FRAMES frames of view 0
under `record_stages` (CUDA events). It prints one JSON line per process,
then a summary per tree (the median frame of each view over both of its
processes, and the median of each stage), the card's name and power limit,
and writes everything to chiprun_out/serve_ab.json.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 5
STAGE_FRAMES = 5


def worker(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import tpu_splat_torch
    from tpu_splat_torch.core.device import record_stages
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import build
    from tpu_splat_torch.raster.config import production_config
    from tpu_splat_torch.renderer import render_fast

    if not os.path.abspath(tpu_splat_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"tpu_splat_torch came from {tpu_splat_torch.__file__}, not {tree}")
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda:0")
    build.build_all()
    state = cs.build_state(cs.N_GAUSS, cs.CAPACITY, device=dev)
    cfg = production_config(**cs.PROD)
    views = [orbit_camera(cs.H, cs.W, radius=6.0, azimuth=0.4 + k * math.pi / 2,
                          elevation=0.3, device=dev) for k in range(cs.N_VIEWS)]
    bg = torch.zeros(3, device=dev)
    serve = lambda k: render_fast(state, views[k], cfg, bg, collect_weights=False)
    serve(0)  # warm-up
    frames = {k: [] for k in range(cs.N_VIEWS)}
    for _ in range(REPS):
        for k in frames:
            frames[k].append(cs.wall_ms(lambda: serve(k))[0])
    runs = []
    for _ in range(STAGE_FRAMES):
        with record_stages() as st_ms:
            total, _ = cs.wall_ms(lambda: serve(0))
        runs.append(dict(st_ms, render_fast_wall=total))
    stages = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    print(json.dumps({"tree": tree, "frames_ms": frames, "stages_ms": stages}), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    base = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else HERE)
    runs = []
    for label, tree in (("base", base), ("change", change), ("change", change),
                        ("base", base)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
            raise RuntimeError(f"{label} run failed with exit code {out.returncode}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["label"] = label
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for label in ("base", "change"):
        mine = [r for r in runs if r["label"] == label]
        views = mine[0]["frames_ms"].keys()
        summary[label] = dict(
            view_median_ms={k: float(np.median(sum((r["frames_ms"][k] for r in mine), [])))
                            for k in views},
            all_median_ms=float(np.median(sum((v for r in mine for v in r["frames_ms"].values()),
                                              []))),
            stages_median_ms={k: float(np.median([r["stages_ms"][k] for r in mine]))
                              for k in mine[0]["stages_ms"]},
        )
        print(f"[{label}] " + json.dumps(summary[label]), flush=True)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(card)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "serve_ab.json"), "w") as f:
        json.dump(dict(runs=runs, summary=summary, card=card), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
