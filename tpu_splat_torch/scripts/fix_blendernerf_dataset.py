"""Normalize BlenderNeRF exports into the loader's expected layout (port of
tpu_splat/scripts/fix_blendernerf_dataset.py; role of reference
scripts/fix_blendernerf_dataset.py). Host only.

Per scene: back up transforms_train.json, rewrite file_path entries
('train/...' -> 'rgb/...', extension stripped), split every `step`-th frame
into a new transforms_test.json, and rename the train/ image folder to rgb/.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
from argparse import ArgumentParser
from pathlib import Path


def fix_file_path(fp: str) -> str:
    p = Path(fp)
    parts = list(p.parts)
    if parts and parts[0] == "train":
        parts[0] = "rgb"
    if len(parts) >= 2 and parts[0] in (".", "") and parts[1] == "train":
        parts[1] = "rgb"
    return Path(*parts).with_suffix("").as_posix()


def process_scene(scene_dir: Path, step: int = 8, start_index: int = 0) -> bool:
    train_json = scene_dir / "transforms_train.json"
    if not train_json.exists():
        print(f"  [!] no transforms_train.json in {scene_dir}, skipping")
        return False

    backup = scene_dir / "transforms_train_original.json.bak"
    if not backup.exists():
        shutil.copy2(train_json, backup)

    with open(train_json, encoding="utf-8") as f:
        data = json.load(f)
    frames = data.get("frames", [])
    if not frames:
        print(f"  [!] no frames in {train_json}, skipping")
        return False

    for fr in frames:
        if "file_path" in fr:
            fr["file_path"] = fix_file_path(fr["file_path"])

    test_frames = [
        fr for i, fr in enumerate(frames) if (i - start_index) % step == 0
    ]
    train_frames = [
        fr for i, fr in enumerate(frames) if (i - start_index) % step != 0
    ]

    data["frames"] = train_frames
    with open(train_json, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
    test_data = dict(data)
    test_data["frames"] = test_frames
    with open(scene_dir / "transforms_test.json", "w", encoding="utf-8") as f:
        json.dump(test_data, f, indent=2)

    train_dir = scene_dir / "train"
    rgb_dir = scene_dir / "rgb"
    if train_dir.is_dir() and not rgb_dir.exists():
        train_dir.rename(rgb_dir)
    print(
        f"  [+] {scene_dir.name}: {len(train_frames)} train / "
        f"{len(test_frames)} test frames"
    )
    return True


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("root", help="scene dir, or a dir of scene dirs")
    parser.add_argument("--step", type=int, default=8)
    parser.add_argument("--start_index", type=int, default=0)
    args = parser.parse_args(argv)

    root = Path(args.root)
    if (root / "transforms_train.json").exists():
        scenes = [root]
    else:
        scenes = sorted(d for d in root.iterdir() if d.is_dir())
    n = sum(process_scene(s, args.step, args.start_index) for s in scenes)
    print(f"processed {n} scene(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
