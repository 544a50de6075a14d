"""Run the model-statistics report over an eval tree (port of
tpu_splat/scripts/full_report.py; role of reference full_report.py).

For every scene dir under --output_path, runs tpu_splat_torch.scripts.report with
per-dataset render args from scene_args.yaml (reference full_report.py:36-59).
"""
from __future__ import annotations

import os
import subprocess
import sys
from argparse import ArgumentParser


def load_scene_args(path: str = "scene_args.yaml") -> dict:
    if not os.path.exists(path):
        return {}
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def render_args_for(scene: str, scene_args: dict) -> list[str]:
    dataset = scene.split("/")[0]
    data = scene_args.get("data", {})
    if dataset in data.get("realDatasets", []):
        return scene_args.get("real", {}).get("render", "").split()
    if dataset in data.get("syntheticDatasets", []):
        return scene_args.get("synthetic", {}).get("render", "").split()
    return []


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--scenes", nargs="+", default=None)
    parser.add_argument("--scene_args", default="scene_args.yaml")
    args = parser.parse_args(argv)

    scene_args = load_scene_args(args.scene_args)
    scenes = args.scenes
    if scenes is None:
        scenes = sorted(
            d
            for d in os.listdir(args.output_path)
            if os.path.isdir(os.path.join(args.output_path, d))
        )
    for scene in scenes:
        out = os.path.join(args.output_path, scene)
        cmd = (
            [sys.executable, "-m", "tpu_splat_torch.scripts.report", "-m", out]
            + render_args_for(scene, scene_args)
        )
        print("+", " ".join(cmd))
        subprocess.call(cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
