"""Find the frame rate a viewer cell sustains: run its driver at a few
offered rates (0 asks as fast as the server answers) and print each run's
latencies and how many frames came late.

    python3 -m splatbench.tools.sweep --workload <serve cell> --seed N --seconds S --rates 0 18 20 22
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from splatbench import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args(argv)
    bench, cell, conf, mix, limits = run.load_cell(a.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for rate in a.rates:
        m = dict(mix, rate_hz=rate, check_frames=1)
        ctx = run.Context(cell=cell, config=conf, traffic=m, limits=limits, seed=a.seed,
                          seconds=a.seconds, trace=False, device=torch.device("cuda:0"),
                          t_start=time.perf_counter())
        line = run.execute(ctx, bench)
        lat = line["_detail"]["latency_ms"]
        print(json.dumps(dict(rate_hz=rate, frames_per_s=lat["frames"] / line["_detail"]["window_s"],
                              **lat)), flush=True)


if __name__ == "__main__":
    main()
