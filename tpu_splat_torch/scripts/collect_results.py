"""Aggregate per-scene results into a TSV (a copy of
tpu_splat/scripts/collect_results.py, so that no module of the port imports
the JAX package; role of reference collect_results.py):
PSNR/SSIM/LPIPS/fps/gaussian-count per scene + results_all.csv."""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--scenes", nargs="+", required=True)
    args = parser.parse_args(argv)

    rows = [("scene", "PSNR", "SSIM", "LPIPS", "fps", "n_gaussians")]
    for scene in args.scenes:
        out = os.path.join(args.output_path, scene)
        psnr = ssim = lpips = fps = count = ""
        rj = os.path.join(out, "results.json")
        if os.path.exists(rj):
            with open(rj) as f:
                res = json.load(f)
            if res:
                best = sorted(res.keys())[-1]
                psnr = f"{res[best]['PSNR']:.4f}"
                ssim = f"{res[best]['SSIM']:.4f}"
                lpips = f"{res[best]['LPIPS']:.4f}"
        ft = os.path.join(out, "fps.txt")
        if os.path.exists(ft):
            lines = open(ft).read().split()
            fps = f"{float(lines[0]):.2f}"
            count = lines[1] if len(lines) > 1 else ""
        rows.append((scene, psnr, ssim, lpips, fps, count))

    csv = os.path.join(args.output_path, "results_all.csv")
    with open(csv, "w") as f:
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")
    print(open(csv).read())


if __name__ == "__main__":
    main()
