"""COLMAP dataset conversion driver (port of tpu_splat/scripts/convert.py;
role of reference convert.py). Host only.

    python -m tpu_splat_torch.scripts.convert -s <scene_dir> [--resize]

Runs feature extraction -> exhaustive matching -> mapping -> undistortion via
the COLMAP CLI (convert.py:31-79), then optionally builds the images_2/4/8
multi-resolution pyramid — with PIL instead of ImageMagick, so no external
resize tool is needed (reference convert.py:92-123 shells to `magick`).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser


def run(cmd: list[str]) -> int:
    print("+", " ".join(cmd))
    return subprocess.call(cmd)


def resize_pyramid(source_path: str):
    from PIL import Image

    src_dir = os.path.join(source_path, "images")
    for div in (2, 4, 8):
        os.makedirs(os.path.join(source_path, f"images_{div}"), exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        img = Image.open(os.path.join(src_dir, name))
        for div in (2, 4, 8):
            w, h = img.width // div, img.height // div
            img.resize((max(w, 1), max(h, 1)), Image.LANCZOS).save(
                os.path.join(source_path, f"images_{div}", name)
            )


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="colmap")
    parser.add_argument("--resize", action="store_true")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        print(f"[!] COLMAP executable '{colmap}' not found on PATH")
        return 1
    use_gpu = "0" if args.no_gpu else "1"
    sp = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(sp, "distorted", "sparse"), exist_ok=True)
        if run([
            colmap, "feature_extractor",
            "--database_path", os.path.join(sp, "distorted", "database.db"),
            "--image_path", os.path.join(sp, "input"),
            "--ImageReader.single_camera", "1",
            "--ImageReader.camera_model", args.camera,
            "--SiftExtraction.use_gpu", use_gpu,
        ]):
            return 1
        if run([
            colmap, "exhaustive_matcher",
            "--database_path", os.path.join(sp, "distorted", "database.db"),
            "--SiftMatching.use_gpu", use_gpu,
        ]):
            return 1
        if run([
            colmap, "mapper",
            "--database_path", os.path.join(sp, "distorted", "database.db"),
            "--image_path", os.path.join(sp, "input"),
            "--output_path", os.path.join(sp, "distorted", "sparse"),
            "--Mapper.ba_global_function_tolerance=0.000001",
        ]):
            return 1

    if run([
        colmap, "image_undistorter",
        "--image_path", os.path.join(sp, "input"),
        "--input_path", os.path.join(sp, "distorted", "sparse", "0"),
        "--output_path", sp,
        "--output_type", "COLMAP",
    ]):
        return 1

    # move sparse/* into sparse/0 (reference convert.py:81-89)
    sparse = os.path.join(sp, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        print("Building resolution pyramid (PIL)...")
        resize_pyramid(sp)
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
