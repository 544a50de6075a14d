"""The port's training CLI on the CPU (`main(..., device="cpu")`): ten
iterations on the 32x32 Blender scene of tests/test_scripts.py, with test
renders, a checkpoint, a PLY snapshot and a resume from the checkpoint;
then its PLY (with both sidecars), checkpoint and cfg_args load in the JAX
package, bit equal to the state the CLI returned. Rect and --tight_culling
binning both run, and `--mesh tiles|dp` over two gloo ranks.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_scripts import _make_scene
from tpu_splat.config import OptimizationParams as JOpt
from tpu_splat.config import build_parser as j_build_parser
from tpu_splat.config import get_combined_args as j_get_combined_args
from tpu_splat.model import io as jio
from tpu_splat.model.state import init_from_pcd as j_init_from_pcd
from tpu_splat.train.step import TrainState as JTrainState

from tpu_splat_torch.model import convert
from tpu_splat_torch.model import io as tio
from tpu_splat_torch.scripts import train as tcli

ARGS = ["--eval", "-q", "--num_points", "300", "--init_until_iter", "5",
        "--cubemap_resol", "8", "--max_tiles_per_gaussian", "8", "--max_instances", "8192",
        "--tile_depth", "256"]


def _run(src, out, *extra):
    return tcli.main(["-s", src, "-m", out, *ARGS, *extra], device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    src, out = str(root / "scene"), str(root / "model")
    _make_scene(src)
    ts = _run(src, out, "--disable_viewer", "--iterations_override", "10",
              "--test_iterations", "1", "10", "--save_iterations", "5",
              "--checkpoint_iterations", "5")
    return dict(src=src, out=out, ts=ts)


def _host(t):
    return t.detach().cpu().numpy()


def test_cli_trains_and_writes(run):
    out, ts = run["out"], run["ts"]
    assert ts.step == 10
    for f in ("cfg_args", "cameras.json", "training_report.jsonl", "chkpnt5.npz"):
        assert os.path.exists(os.path.join(out, f)), f
    for it in (5, 10):
        base = os.path.join(out, "point_cloud", f"iteration_{it}", "point_cloud")
        for ext in (".ply", ".map.npz", ".map"):
            assert os.path.exists(base + ext), (it, ext)
    with open(os.path.join(out, "training_report.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iteration"] for r in rows] == [1, 10]
    assert all(np.isfinite(r[s]["psnr"]) for r in rows for s in ("test", "train"))
    for k, v in ts.gaussians.param_pytree().items():
        assert torch.isfinite(v).all(), k


def test_cli_outputs_load_in_jax(run):
    out, ts = run["out"], run["ts"]
    g = ts.gaussians
    alive = _host(g.alive)
    j = jio.load_ply(os.path.join(out, "point_cloud", "iteration_10", "point_cloud.ply"))
    n = int(alive.sum())
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), _host(getattr(g, f))[alive], f)
    np.testing.assert_array_equal(np.asarray(j.env.texture), _host(g.env.texture))
    assert int(np.asarray(j.alive).sum()) == n
    # the checkpoint against a JAX template of the same run
    parser = j_build_parser(fill_none_model=True)
    args = j_get_combined_args(parser, ["-m", out])
    assert args.source_path == run["src"] and args.num_points == 300
    assert args.cubemap_resol == 8 and args.iterations == 10
    pts = np.zeros((300, 3), np.float32)
    jstate = j_init_from_pcd(pts, pts, capacity=16384, max_sh_degree=3, cubemap_resolution=8)
    template = JTrainState.create(jstate, JOpt(), num_frames=4)
    back, it = jio.load_checkpoint(os.path.join(out, "chkpnt5.npz"), template)
    assert it == 5 and int(back.step) == 5
    gck, _ = jio.load_checkpoint_gaussians(os.path.join(out, "chkpnt5.npz"))
    tck, _ = tio.load_checkpoint_gaussians(os.path.join(out, "chkpnt5.npz"), device="cpu")
    np.testing.assert_array_equal(np.asarray(gck.xyz), _host(tck.xyz))
    assert jio.load_checkpoint_isp(os.path.join(out, "chkpnt5.npz")) is not None


def test_cli_resumes_from_checkpoint(run, tmp_path):
    ts = _run(run["src"], str(tmp_path / "m"), "--disable_viewer", "--iterations_override",
              "8", "--test_iterations", "8", "--start_checkpoint",
              os.path.join(run["out"], "chkpnt5.npz"))
    assert ts.step == 8
    ck, _ = tio.load_checkpoint(os.path.join(run["out"], "chkpnt5.npz"), ts)
    assert ck.step == 5 and ts.opt.count == 8


def test_cli_tight_culling_and_no_viewer(run, tmp_path, capsys):
    """Without --disable_viewer the CLI binds the viewer; where the port is
    taken it says so in one line and trains on, as the JAX CLI."""
    import socket

    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen()
    port = busy.getsockname()[1]
    try:
        ts = _run(run["src"], str(tmp_path / "m"), "--iterations_override", "3",
                  "--test_iterations", "3", "--tight_culling", "--port", str(port))
    finally:
        busy.close()
    assert ts.step == 3
    assert f"viewer disabled (cannot bind 127.0.0.1:{port}" in capsys.readouterr().out


def test_cli_serves_the_viewer_while_training(run, tmp_path, monkeypatch):
    """A client connects while the CLI trains: one request is answered
    between two steps (an RGB frame through the ISP's controller, the
    iteration in its metrics), the connection closes after it (no
    keep_alive), and training runs on to its last step."""
    import socket
    import threading

    from tests.test_torch_viewer import read_modes, read_reply, request
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.viewer import network_gui

    guis, got = [], {}

    class Recording(network_gui.NetworkGUI):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            guis.append(self)

    monkeypatch.setattr(network_gui, "NetworkGUI", Recording)

    def client():
        for _ in range(1200):
            if guis:
                break
            threading.Event().wait(0.05)
        cam = orbit_camera(24, 40, radius=4.0, device="cpu")
        s = socket.create_connection(("127.0.0.1", guis[0].listener.getsockname()[1]),
                                     timeout=120)
        got["modes"] = read_modes(s)
        request(s, 40, 24, 0, cam.world_view, cam.full_proj, cam.fovx, cam.fovy,
                keep_alive=False)
        got["reply"] = read_reply(s, 40, 24)
        got["closed"] = s.recv(1) == b""
        s.close()

    t = threading.Thread(target=client)
    t.start()
    ts = _run(run["src"], str(tmp_path / "m"), "--iterations_override", "6",
              "--test_iterations", "6", "--port", "0")
    t.join(timeout=120)
    assert not t.is_alive() and ts.step == 6 and guis[0].closed
    frame, path, metrics = got["reply"]
    assert frame.shape == (24, 40, 3) and frame.dtype == np.uint8 and frame.any()
    assert path == run["src"] and 1 <= metrics["it"] <= 6 and got["closed"]


@pytest.mark.parametrize("mesh", ["tiles", "dp"])
def test_cli_mesh_not_ported(run, tmp_path, mesh, capfd):
    """--mesh tiles|dp (the name is from when the port refused both; they
    now run, and the test keeps its name): the CLI starts two gloo
    ranks for three iterations. Rank 0 alone writes, and writes the files a
    one-device run writes; its PLY and checkpoint load in both packages, bit
    equal to the state it returns."""
    out = str(tmp_path / "m")
    ts = _run(run["src"], out, "--disable_viewer", "--iterations_override", "3",
              "--test_iterations", "99", "--checkpoint_iterations", "3", "--mesh", mesh,
              "--mesh_devices", "2")
    text = capfd.readouterr().out
    assert text.count(f"mesh: {mesh} over 2 devices") == 1
    assert text.count("Training complete") == 1 and text.count("Saving Checkpoint") == 1
    assert ts.step == 3 and ts.opt.count == 3
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, names in os.walk(out) for f in names)
    ply = os.path.join("point_cloud", "iteration_3", "point_cloud")
    assert files == sorted(["cameras.json", "cfg_args", "chkpnt3.npz",
                            ply + ".map", ply + ".map.npz", ply + ".ply"])
    g = ts.gaussians
    alive = _host(g.alive)
    j = jio.load_ply(os.path.join(out, ply + ".ply"))
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity", "refl"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), _host(getattr(g, f))[alive], f)
    pts = np.zeros((300, 3), np.float32)
    jstate = j_init_from_pcd(pts, pts, capacity=16384, max_sh_degree=3, cubemap_resolution=8)
    back, it = jio.load_checkpoint(os.path.join(out, "chkpnt3.npz"),
                                   JTrainState.create(jstate, JOpt(), num_frames=4))
    assert it == 3 and int(back.step) == 3
    np.testing.assert_array_equal(np.asarray(back.gaussians.xyz), _host(g.xyz))
    np.testing.assert_array_equal(np.asarray(back.isp.gain), _host(ts.isp.gain))
    tback, it = tio.load_checkpoint(os.path.join(out, "chkpnt3.npz"), ts)
    assert it == 3 and torch.equal(tback.gaussians.rotation, g.rotation)
    assert torch.equal(tback.opt.nu["xyz"], ts.opt.nu["xyz"])


def test_cli_dp_buckets_mixed_camera_sizes():
    """--mesh dp pads cameras of mixed sizes to the largest, keeping each
    one's pixels in place, with a loss mask over its own pixels."""
    from tpu_splat_torch.data.scene import LoadedCamera
    from tpu_splat_torch.data.synthetic import orbit_camera

    cams = [LoadedCamera(orbit_camera(h, w, radius=4.0, device="cpu"),
                         torch.rand((h, w, 3)), torch.rand((h, w, 1)), f"c{i}", i)
            for i, (h, w) in enumerate([(32, 48), (24, 40), (32, 48)])]
    before = [(lc.image.clone(), lc.camera) for lc in cams]
    assert tcli._bucket_camera_sizes(cams) == 2
    for lc, (img, cam) in zip(cams, before):
        h, w = img.shape[:2]
        assert (lc.camera.height, lc.camera.width) == lc.image.shape[:2] == (32, 48)
        assert lc.alpha.shape[:2] == lc.pix_mask.shape[:2] == (32, 48)
        assert torch.equal(lc.image[:h, :w], img) and lc.image[h:].abs().sum() == 0
        assert float(lc.pix_mask.sum()) == h * w and float(lc.pix_mask[:h, :w].min()) == 1.0
        assert torch.equal(lc.camera.world_view, cam.world_view)
    assert tcli._bucket_camera_sizes(cams[:1]) == 1


def test_dump_snapshot_layout_matches_jax(run, tmp_path):
    """The failure snapshot: the JAX package's keys, dtypes and shapes, and
    the same arrays for the same state and camera."""
    from tpu_splat.core.graphics import Camera as JCamera
    from tpu_splat.raster.config import RasterConfig as JRC
    from tpu_splat.train.debug_dump import dump_snapshot as j_dump

    from tpu_splat_torch.core.graphics import Camera as TCamera
    from tpu_splat_torch.raster.config import RasterConfig as TRC
    from tpu_splat_torch.train.debug_dump import dump_snapshot as t_dump

    j = jio.load_checkpoint_gaussians(os.path.join(run["out"], "chkpnt5.npz"))[0]
    t = tio.load_checkpoint_gaussians(os.path.join(run["out"], "chkpnt5.npz"), device="cpu")[0]
    R, T = np.eye(3) * [1, -1, -1], np.array([0.1, 0.2, 4.0])
    jcam = JCamera.create(R=R, T=T, fovx=0.8, fovy=0.8, height=32, width=32)
    tcam = TCamera.create(R=R, T=T, fovx=0.8, fovy=0.8, height=32, width=32, device="cpu")
    gt = np.random.default_rng(0).uniform(size=(32, 32, 3)).astype(np.float32)
    kw = dict(max_instances=4096, max_tiles_per_gaussian=8, tile_depth=256)
    pj = j_dump(str(tmp_path / "j"), j, jcam, jnp.asarray(gt), 7, "why", cfg=JRC(**kw),
                bg=jnp.zeros(3))
    pt = t_dump(str(tmp_path / "t"), t, tcam, torch.from_numpy(gt), 7, "why", cfg=TRC(**kw),
                bg=torch.zeros(3))
    assert t_dump(str(tmp_path / "t"), t, tcam, None, 8, "again") == ""  # the first is kept
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _Board:
    """Stands in for a TensorBoard writer and keeps what is logged."""

    def __init__(self):
        self.scalars, self.histograms = {}, {}

    def add_scalar(self, name, value, it):
        self.scalars[name, it] = float(value)

    def add_histogram(self, name, values, it):
        self.histograms[name, it] = np.asarray(values)

    def close(self):
        pass


EVAL_TOL = 2e-5  # render_fast's render, absolute (tests/test_torch_render.py)


def test_reporter_matches_jax(run, tmp_path):
    """Both packages' TrainReporter on one state (the CLI's checkpoint at 5,
    its opacity and refl logits redrawn from a seed) and each package's
    Scene of the CLI's scene: evaluate's L1 and PSNR per set, the scalars
    it logs, and model_stats' histograms and point count.

    Tolerances: L1 within EVAL_TOL (clamping keeps each pixel within it);
    PSNR within what EVAL_TOL moves it by, (10 / ln 10) (2 EVAL_TOL L1 +
    EVAL_TOL^2) / mse at the set's L1 and PSNR; the histograms bit-equal
    (f32.sigmoid against jax.nn.sigmoid).
    """
    import dataclasses

    from tpu_splat.data.scene import Scene as JScene
    from tpu_splat.raster.config import RasterConfig as JRC
    from tpu_splat.train.report import TrainReporter as JReporter

    from tpu_splat_torch.data.scene import Scene as TScene
    from tpu_splat_torch.raster.config import RasterConfig as TRC
    from tpu_splat_torch.train.report import TrainReporter as TReporter

    ck = os.path.join(run["out"], "chkpnt5.npz")
    jg, tg = jio.load_checkpoint_gaussians(ck)[0], tio.load_checkpoint_gaussians(ck, "cpu")[0]
    rng = np.random.default_rng(11)
    logits = {f: rng.normal(0.0, 2.0, tuple(tg.opacity.shape)).astype(np.float32)
              for f in ("opacity", "refl")}
    jg = jg.replace(**{f: jnp.asarray(v) for f, v in logits.items()})
    tg = dataclasses.replace(tg, **{f: torch.from_numpy(v) for f, v in logits.items()})
    kw = dict(max_tiles_per_gaussian=8, max_instances=8192, tile_depth=256)
    got = {}
    for name, reporter, g, cfg, scene in (
            ("jax", JReporter, jg, JRC(backend="pallas", **kw),
             JScene(run["src"], eval_split=True, num_points=300)),
            ("port", TReporter, tg, TRC(**kw),
             TScene(run["src"], eval_split=True, num_points=300, device="cpu"))):
        os.makedirs(tmp_path / name)
        rep = reporter(str(tmp_path / name), enable_tb=False)
        rep.tb = _Board()
        res = rep.evaluate(5, g, cfg, [0.0, 0.0, 0.0], scene.test_cameras, scene.train_cameras)
        rep.model_stats(5, g)
        with open(tmp_path / name / "training_report.jsonl") as f:
            row = json.loads(f.read())
        got[name] = (res, row, rep.tb)
    (jres, jrow, jtb), (tres, trow, ttb) = got["jax"], got["port"]
    assert sorted(tres) == sorted(jres) == ["test", "train"]
    assert trow == {"iteration": 5, **tres} and jrow == {"iteration": 5, **jres}
    for s in jres:
        l1, p = jres[s]["l1"], jres[s]["psnr"]
        assert abs(tres[s]["l1"] - l1) <= EVAL_TOL, (s, tres[s], jres[s])
        tol = 10 / np.log(10) * (2 * EVAL_TOL * l1 + EVAL_TOL**2) / 10 ** (-p / 10)
        assert abs(tres[s]["psnr"] - p) <= tol, (s, tres[s], jres[s], tol)
    assert sorted(ttb.scalars) == sorted(jtb.scalars)
    assert ttb.scalars[("total_points", 5)] == jtb.scalars[("total_points", 5)]
    assert sorted(ttb.histograms) == sorted(jtb.histograms)
    for k, v in jtb.histograms.items():
        np.testing.assert_array_equal(ttb.histograms[k], v, str(k))


def test_smooth_loss_matches_jax():
    from tpu_splat.train.losses import smooth_loss as j_smooth

    from tpu_splat_torch.train.losses import smooth_loss as t_smooth

    rng = np.random.default_rng(5)
    disp = rng.uniform(0, 2, (24, 30, 1)).astype(np.float32)
    img = rng.uniform(0, 1, (24, 30, 3)).astype(np.float32)
    want = float(jax.jit(j_smooth)(disp, img))
    got = float(t_smooth(torch.from_numpy(disp), torch.from_numpy(img)))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
