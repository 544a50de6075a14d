"""Rewrite persisted cfg_args paths after moving model/dataset trees (port of
tpu_splat/scripts/fix_update_cfg_args.py; role of reference
scripts/fix_update_cfg_args.py). Host only.

For every scene dir containing cfg_args under --root: set model_path to the
scene dir's current location and re-root source_path onto --dataset_dir.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser, Namespace
from pathlib import Path


def process_scene(scene_dir: Path, dataset_dir: Path | None, old_root: str):
    cfg_path = scene_dir / "cfg_args"
    if not cfg_path.exists():
        return False
    with open(cfg_path, encoding="utf-8") as f:
        cfg = eval(f.read(), {"Namespace": Namespace})  # reference format

    cfg.model_path = str(scene_dir)
    if dataset_dir is not None and getattr(cfg, "source_path", None):
        suffix = cfg.source_path.split(old_root)[-1].lstrip("/\\")
        cfg.source_path = str(dataset_dir / suffix)
    with open(cfg_path, "w", encoding="utf-8") as f:
        f.write(str(cfg))
    print(f"  [+] {scene_dir}: model_path/source_path updated")
    return True


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--root", required=True, help="tree of model dirs")
    parser.add_argument("--dataset_dir", default=None)
    parser.add_argument(
        "--old_root", default="/mnt/data",
        help="source_path prefix to strip before re-rooting",
    )
    args = parser.parse_args(argv)

    root = Path(args.root)
    dataset_dir = Path(args.dataset_dir) if args.dataset_dir else None
    n = 0
    for cfg in sorted(root.rglob("cfg_args")):
        n += process_scene(cfg.parent, dataset_dir, args.old_root)
    print(f"updated {n} cfg_args file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
