"""The port's dataset-prep scripts (`tpu_splat_torch/scripts/{convert,
make_depth_scale,fix_blendernerf_dataset,fix_update_cfg_args}.py`, host
only) against the JAX package's, each on its own copy of one fixture (the
scenes of tests/test_dataset_prep.py): every file they leave is byte-equal.
convert runs with a fake `colmap` on PATH that records its calls; both
packages must issue the same commands.
"""
import importlib
import json
import os
import stat
import sys
from argparse import Namespace

import numpy as np
import pytest
from PIL import Image

PKGS = ("tpu_splat", "tpu_splat_torch")


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _run_both(tmp_path, name, make, argv):
    """make(dir) builds the fixture; argv(dir) the script's arguments. ->
    {package: tree after the run}, the return codes held 0."""
    trees = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        make(d)
        mod = importlib.import_module(f"{pkg}.scripts.{name}")
        assert mod.main(argv(d)) == 0
        trees[pkg] = _tree(d)
    return trees


def _depth_scene(d):
    """tests/test_dataset_prep.py:test_make_depth_scale's scene: one PINHOLE
    view of 60 tracked points and a 16-bit inverse mono-depth PNG."""
    from tpu_splat.data.colmap import ColmapCamera, ColmapImage, write_model

    rng = np.random.default_rng(1)
    W, H, fx = 64, 48, 60.0
    cams = {1: ColmapCamera(1, "PINHOLE", W, H, np.array([fx, fx, W / 2, H / 2]))}
    n = 60
    depth = rng.uniform(2.0, 6.0, n)
    x = rng.uniform(-0.4, 0.4, n) * depth
    y = rng.uniform(-0.3, 0.3, n) * depth
    u, v = fx * x / depth + W / 2, fx * y / depth + H / 2
    imgs = {
        1: ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "im_1.png",
                       xys=np.stack([u, v], 1), point3d_ids=np.arange(1, n + 1, dtype=np.int64)),
        # a second view whose depth map is missing: skipped by both
        2: ColmapImage(2, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "im_2.png",
                       xys=np.stack([u, v], 1), point3d_ids=np.arange(1, n + 1, dtype=np.int64)),
    }
    write_model(cams, imgs, (np.stack([x, y, depth], 1), np.zeros((n, 3), np.uint8),
                             np.zeros(n)), str(d / "scene" / "sparse" / "0"), ext=".bin")
    invd = np.full((H, W), 0.25)
    for ui, vi, di in zip(u, v, depth):
        yi, xi = int(round(vi)), int(round(ui))
        invd[max(yi - 1, 0): yi + 2, max(xi - 1, 0): xi + 2] = 1.0 / di
    os.makedirs(d / "depths")
    img16 = np.clip((invd - 0.1) / 2.0 * 2**16, 0, 2**16 - 1).astype(np.uint16)
    Image.fromarray(img16).save(d / "depths" / "im_1.png")


def test_make_depth_scale_matches_jax(tmp_path):
    trees = _run_both(tmp_path, "make_depth_scale", _depth_scene,
                      lambda d: ["--base_dir", str(d / "scene"), "--depths_dir", str(d / "depths")])
    assert trees["tpu_splat_torch"] == trees["tpu_splat"]
    params = json.loads(trees["tpu_splat_torch"][os.path.join("scene", "sparse", "0",
                                                              "depth_params.json")])
    assert list(params) == ["im_1"] and abs(params["im_1"]["scale"] - 2.0) < 0.4


def _blender_scenes(d):
    """Two BlenderNeRF exports under one root (the fixer's tree mode), one
    of them with './train/' paths."""
    for k, prefix in ((0, "train/"), (1, "./train/")):
        scene = d / f"scene_{k}"
        (scene / "train").mkdir(parents=True)
        (scene / "train" / "r_0.png").write_bytes(b"png")
        frames = [{"file_path": f"{prefix}r_{i}.png", "transform_matrix": np.eye(4).tolist()}
                  for i in range(11)]
        with open(scene / "transforms_train.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


def test_fix_blendernerf_dataset_matches_jax(tmp_path):
    trees = _run_both(tmp_path, "fix_blendernerf_dataset", _blender_scenes,
                      lambda d: [str(d), "--step", "4", "--start_index", "1"])
    assert trees["tpu_splat_torch"] == trees["tpu_splat"]
    assert os.path.join("scene_0", "rgb", "r_0.png") in trees["tpu_splat_torch"]


def test_fix_update_cfg_args_matches_jax(tmp_path):
    def make(d):
        for name, src in (("lego", "/mnt/data/nerf/lego"), ("room", "/other/room")):
            (d / "out" / name).mkdir(parents=True)
            with open(d / "out" / name / "cfg_args", "w") as f:
                f.write(str(Namespace(source_path=src, model_path=f"/old/{name}",
                                      white_background=True, sh_degree=3)))

    trees = _run_both(tmp_path, "fix_update_cfg_args", make,
                      lambda d: ["--root", str(d / "out"), "--dataset_dir", "/data/sets"])
    assert trees["tpu_splat_torch"].keys() == trees["tpu_splat"].keys()
    for k, v in trees["tpu_splat"].items():  # each names its own model directory
        assert trees["tpu_splat_torch"][k] == v.replace(
            str(tmp_path / "tpu_splat").encode(), str(tmp_path / "tpu_splat_torch").encode())


FAKE_COLMAP = """#!{python}
import os, sys
with open(os.environ["COLMAP_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
if sys.argv[1] == "image_undistorter":
    a = dict(zip(sys.argv[2::2], sys.argv[3::2]))
    out = a["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(out, "sparse", name), "wb").write(name.encode())
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    for name in sorted(os.listdir(a["--image_path"])):
        src = os.path.join(a["--image_path"], name)
        open(os.path.join(out, "images", name), "wb").write(open(src, "rb").read())
"""


@pytest.mark.parametrize("flags", [["--resize"], ["--skip_matching", "--no_gpu"]],
                         ids=["full", "skip_matching"])
def test_convert_issues_the_jax_commands(tmp_path, monkeypatch, flags):
    """Feature extraction, matching, mapping and undistortion through the
    (fake) COLMAP CLI, the sparse/0 move and the Pillow pyramid: the same
    commands and the same files."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    colmap = bin_dir / "colmap"
    colmap.write_text(FAKE_COLMAP.format(python=sys.executable))
    colmap.chmod(colmap.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")

    def make(d):
        rng = np.random.default_rng(2)
        (d / "input").mkdir(parents=True)
        for k in range(2):
            Image.fromarray(rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)).save(
                d / "input" / f"im_{k}.png")
        if "--skip_matching" in flags:
            (d / "distorted" / "sparse" / "0").mkdir(parents=True)

    logs = {}
    trees = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        make(d)
        monkeypatch.setenv("COLMAP_LOG", str(tmp_path / f"{pkg}.log"))
        mod = importlib.import_module(f"{pkg}.scripts.convert")
        assert mod.main(["-s", str(d), *flags]) == 0
        logs[pkg] = (tmp_path / f"{pkg}.log").read_text().replace(str(d), "<scene>")
        trees[pkg] = _tree(d)
    assert logs["tpu_splat_torch"] == logs["tpu_splat"]
    n_calls = 1 if "--skip_matching" in flags else 4
    assert len(logs["tpu_splat"].splitlines()) == n_calls
    assert trees["tpu_splat_torch"] == trees["tpu_splat"]
    assert os.path.join("sparse", "0", "cameras.bin") in trees["tpu_splat_torch"]
    if "--resize" in flags:
        assert os.path.join("images_8", "im_1.png") in trees["tpu_splat_torch"]


def test_convert_without_colmap_fails_as_jax(tmp_path):
    for pkg in PKGS:
        mod = importlib.import_module(f"{pkg}.scripts.convert")
        assert mod.main(["-s", str(tmp_path), "--colmap_executable", "no-such-colmap"]) == 1
