"""Collect per-scene metrics into a single CSV (a copy of
tpu_splat/scripts/extract_metrics.py, so that no module of the port imports
the JAX package; role of reference extract_metrics.py).

Reads each scene's fps.txt + results.json under --output_path and writes a
transposed TSV results.csv with one column per scene and rows
PSNR/SSIM/LPIPS/fps/count, matching the reference's spreadsheet-paste format
(extract_metrics.py:27-66). Decimal commas are off by default (--decimal_comma
restores the reference's locale quirk).
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser


def scene_metrics(scene_dir: str):
    fps_value, count = "", ""
    fps_path = os.path.join(scene_dir, "fps.txt")
    if os.path.exists(fps_path):
        with open(fps_path) as fp:
            for line in fp:
                if line.startswith("fps:"):
                    fps_value = line.split(":", 1)[1].strip()
                elif line.startswith("count:"):
                    count = line.split(":", 1)[1].strip()
    results_path = os.path.join(scene_dir, "results.json")
    psnr = ssim = lpips = float("nan")
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
        if results:
            # highest-iteration method key (reference :40-43)
            key = max(results.keys())
            psnr = results[key].get("PSNR", float("nan"))
            ssim = results[key].get("SSIM", float("nan"))
            lpips = results[key].get("LPIPS", float("nan"))
    return [psnr, ssim, lpips, fps_value, count]


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--scenes", nargs="+", default=None)
    parser.add_argument("--decimal_comma", action="store_true")
    args = parser.parse_args(argv)

    scenes = args.scenes
    if scenes is None:
        scenes = sorted(
            d
            for d in os.listdir(args.output_path)
            if os.path.isdir(os.path.join(args.output_path, d))
        )
    metrics = {
        s: scene_metrics(os.path.join(args.output_path, s)) for s in scenes
    }

    def fmt(v):
        s = str(v)
        return s.replace(".", ",") if args.decimal_comma else s

    out_path = os.path.join(args.output_path, "results.csv")
    with open(out_path, "w") as out:
        out.write("\t".join(metrics.keys()) + "\t\n")
        for i in range(5):
            out.write("\t".join(fmt(metrics[s][i]) for s in metrics) + "\t\n")
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
