"""The data layer across the two packages, on the CPU: COLMAP (binary and
text) and Blender scenes built in tmp_path, loaded by both packages'
`Scene`. Cameras are held exactly (both build their matrices in float32
numpy from the same float64 inputs), as are the images (the same decode
and float32 scaling), alpha masks, point clouds, cameras_extent,
cameras_mean, frame indices and cameras.json. Plus the port's copy of the
native PNG loader against Pillow, and its numpy PNG writer.
"""
import json
import os

import numpy as np
import pytest
import torch

from tpu_splat.data.colmap import ColmapCamera, ColmapImage, write_model
from tpu_splat.data.scene import Scene as JScene

from tpu_splat_torch.data import native_loader as tnl
from tpu_splat_torch.data import readers as treaders
from tpu_splat_torch.data.scene import Scene as TScene

N_VIEWS = 9  # llffhold 8: views 0 and 8 are the test split


def _write_colmap(root, ext, w=64, h=48):
    from PIL import Image

    rng = np.random.default_rng(0)
    cams = {1: ColmapCamera(1, "PINHOLE", w, h, np.array([60.0, 62.0, w / 2 + 1.5, h / 2 - 2.0]))}
    imgs = {}
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(N_VIEWS):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        name = f"img_{i}.png"
        imgs[i + 1] = ColmapImage(i + 1, q, rng.normal(size=3), 1, name)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "images", name))
    pts = (rng.normal(size=(50, 3)), rng.integers(0, 256, (50, 3)).astype(np.uint8),
           rng.uniform(0, 1, 50))
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    write_model(cams, imgs, pts, sparse, ext=ext)


def _write_blender(root, size=32):
    """RGBA frames (the alpha path) on an orbit, train and test splits."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(1)
    split = {"train": [], "test": []}
    for i in range(6):
        name = f"r_{i}"
        Image.fromarray(rng.integers(0, 256, (size, size, 4), dtype=np.uint8), "RGBA").save(
            os.path.join(root, name + ".png"))
        c2w = np.eye(4)
        ang = 0.5 * i
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
        c2w[:3, 3] = 4.0 * c2w[:3, 2]
        split["test" if i % 3 == 0 else "train"].append(
            {"file_path": name, "transform_matrix": c2w.tolist()})
    for k, frames in split.items():
        with open(os.path.join(root, f"transforms_{k}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for kind in ("colmap_bin", "colmap_txt", "blender"):
        p = str(root / kind)
        if kind == "blender":
            _write_blender(p)
        else:
            _write_colmap(p, ".bin" if kind == "colmap_bin" else ".txt")
        out[kind] = p
    return out


def _t(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


CASES = [("colmap_bin", True, -1, True), ("colmap_txt", False, -1, True),
         ("colmap_bin", True, 2, False), ("blender", True, -1, True),
         ("blender", False, 1, False)]


@pytest.mark.parametrize("kind,eval_split,resolution,shuffle", CASES)
def test_scene_matches_jax(scenes, tmp_path, kind, eval_split, resolution, shuffle):
    kw = dict(eval_split=eval_split, resolution=resolution, shuffle=shuffle, num_points=200)
    j = JScene(scenes[kind], str(tmp_path / "j"), **kw)
    t = TScene(scenes[kind], str(tmp_path / "t"), device="cpu", **kw)
    assert t.cameras_extent == j.cameras_extent
    np.testing.assert_array_equal(t.cameras_mean, j.cameras_mean)
    for a, b in zip(t.point_cloud, j.point_cloud):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for ts, js in ((t.train_cameras, j.train_cameras), (t.test_cameras, j.test_cameras)):
        assert len(ts) == len(js) and (len(js) > 0 or not eval_split)
        for tc, jc in zip(ts, js):
            assert (tc.image_name, tc.uid, tc.frame_idx) == (jc.image_name, jc.uid, jc.frame_idx)
            assert tc.image.dtype == torch.float32 and tc.image.device.type == "cpu"
            np.testing.assert_array_equal(_t(tc.image), jc.image)
            assert (tc.alpha is None) == (jc.alpha is None)
            if jc.alpha is not None:
                np.testing.assert_array_equal(_t(tc.alpha), jc.alpha)
            for f in ("world_view", "proj", "full_proj", "camera_center", "K"):
                np.testing.assert_array_equal(_t(getattr(tc.camera, f)),
                                              np.asarray(getattr(jc.camera, f)), err_msg=f)
            for f in ("height", "width", "fovx", "fovy", "znear", "zfar"):
                assert getattr(tc.camera, f) == getattr(jc.camera, f), f
    t.save_cameras_json()
    j.save_cameras_json()
    with open(os.path.join(t.model_path, "cameras.json")) as a, \
            open(os.path.join(j.model_path, "cameras.json")) as b:
        assert json.load(a) == json.load(b)
    assert t.decoder.startswith("native")


def test_readers_without_pil_on_png(scenes, monkeypatch):
    """A full-resolution PNG scene reads its sizes and finishes its images
    with no Pillow import."""
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    info = treaders.load_scene_info(scenes["blender"], eval_split=True)
    ci = info.train_cameras[0]
    assert treaders.image_size(ci.image_path) == (32, 32)
    arr = tnl.decode_png(ci.image_path)
    img, alpha = treaders.finish_image(arr, (32, 32), ci.alpha_path)
    assert img.shape == (32, 32, 3) and alpha.shape == (32, 32, 1)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_native_decode_matches_pil(tmp_path, mode):
    from PIL import Image

    ch = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    arr = np.random.default_rng(ch).integers(0, 256, (45, 67, ch), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    Image.fromarray(arr[..., 0] if ch == 1 else arr, mode=mode).save(p)
    ref = np.asarray(Image.open(p))
    ref = ref[..., None] if ref.ndim == 2 else ref
    np.testing.assert_array_equal(tnl.decode_png(p), ref)
    # the numpy writer, every row filter: Pillow and the native decoder
    # read back the array it wrote
    q = str(tmp_path / "b.png")
    tnl.write_png(q, arr, filters=(0, 1, 2, 3, 4))
    back = np.asarray(Image.open(q))
    np.testing.assert_array_equal(back[..., None] if back.ndim == 2 else back, arr)
    np.testing.assert_array_equal(tnl.decode_png(q), arr)


def test_prefetch_order_and_pil_fallback(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    paths, want = [], []
    for i in range(7):
        a = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
        p = str(tmp_path / (f"{i}.jpg" if i == 3 else f"{i}.png"))
        Image.fromarray(a).save(p)
        paths.append(p)
        want.append(np.asarray(Image.open(p)))
    got = list(tnl.PrefetchingImageLoader(paths, threads=3))
    assert [i for i, _ in got] == list(range(7))
    for (_, a), w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert tnl.decoder().startswith("native (libtpusplat_io-")
