"""The port's evaluation CLIs on the CPU (`main(..., device="cpu")`) against
the JAX package's CLIs, on the 32x32 Blender scene of tests/test_scripts.py
and a 300-Gaussian model (a PLY, a checkpoint with a trained-looking ISP,
and cfg_args) built from a seed.

The JAX CLIs run with their renderer on the Pallas kernels in interpret
mode (backend="pallas", jitted): the JAX package's CPU `auto` blend rounds
apart from its own kernels (ROADMAP Queue C), and the port's plain kernel
versions follow the kernels. Each package writes into its own copy of the
model directory; every JAX reference is computed once per module. The
trainer's caps in cfg_args (CAPS) set render.py's and eval_fps.py's
config in both packages, and the port's eval_mae, visible_gaussians and
trajectory CLIs' too (they take render.py's capacity flags); the JAX ones
render at RasterConfig(). No frame here overflows either, so the outputs
are held equal all the same.

Tolerances:
- every rendered PNG (renders, normals, refl, env previews, checkpoint
  renders with the ISP, trajectory colour and depth frames, diff-map
  sheets): the JAX CLI's decoded pixels, but +-1 level on at most 8 px per
  4096 (the alpha ~ 1/255 accept flips, PARITY.md D4, quantised); the
  ground-truth PNGs exact;
- metrics on one PNG directory: PSNR within 1e-4 dB, SSIM within 1e-5 (XLA
  and PyTorch sum the SSIM window in another order), GMSD exact, LPIPS NaN
  in both, equal JSON keys;
- counts (visible, total, fps.txt's Gaussian count), the pruned PLY's bytes
  and the model report exact; the normal MAE within 1e-3 degrees (render
  normals agree within 2e-5, tests/test_torch_render.py).
"""
import argparse
import glob
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_scripts import _make_scene

SCENE_SIZE = 32
N_VIEWS = 3  # the test view is the first train view
N_GAUSS = 300  # all alive: the PLY and the checkpoint render at one shape
ITERATION = 7  # the PLY snapshot's
CK_ITERATION = 5  # the checkpoint's: its renders go to ours_5
N_FRAMES = 2
# the trainer's caps, persisted in cfg_args
CAPS = ["--max_tiles_per_gaussian", "8", "--max_instances", "8192", "--tile_depth", "256"]
FLIPS_PER_4096 = 8


def _jax_rendering(mp):
    """Put the JAX CLIs' renderer on the Pallas kernels, jitted once per
    (function, config, switches); the env previews and the ISP jitted too.
    eval_fps, the only caller that passes collect_weights=False, times a
    zero image instead: only its fps.txt's Gaussian count is compared."""
    import jax
    import jax.numpy as jnp

    import tpu_splat
    import tpu_splat.isp.ppisp as jisp
    import tpu_splat.raster.config as jrc
    import tpu_splat.renderer as jren

    real_rc, cache = jrc.RasterConfig, {}

    def jitted(fn):
        def call(state, cam, cfg, bg, **kw):
            if kw.get("collect_weights") is False:
                return argparse.Namespace(render=jnp.zeros((cam.height, cam.width, 3)))
            key = (fn.__name__, cfg, tuple(sorted(kw.items())))
            if key not in cache:
                cache[key] = jax.jit(lambda s, c, b: fn(s, c, cfg, b, **kw))
            return cache[key](state, cam, jnp.asarray(bg))
        return call

    mp.setattr(jrc, "RasterConfig", lambda **k: real_rc(**{"backend": "pallas", **k}))
    mp.setattr(jren, "render_fast", jitted(jren.render_fast))
    mp.setattr(jren, "render", jitted(jren.render))
    mp.setattr(jren, "render_env_map", jax.jit(jren.render_env_map))
    mp.setattr(jisp, "apply_isp", jax.jit(jisp.apply_isp, static_argnames=("frame_idx",)))
    mp.setattr(tpu_splat, "setup_compilation_cache", lambda *a, **k: None)


def _train_flags(src, out):
    """The Namespace the port's train CLI persists as cfg_args for `-s src
    -m out --eval` (its `training` is not run)."""
    from tpu_splat_torch.scripts import train as tcli

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "training", lambda args, **kw: args)
        return tcli.main(["-s", src, "-m", out, "--eval", *CAPS], device="cpu")


def _model_dirs(root, src, state, ts):
    """-> (model, checkpoint model). The first as the train CLI leaves it:
    its cfg_args (naming its own path) and the PLY of ITERATION with its
    sidecars. The second holds chkpnt<CK_ITERATION>.npz and a cfg_args of
    the model flags alone: the train CLI's carries start_checkpoint=None,
    and persisted values win over the command line (get_combined_args, as
    in the JAX package), so --start_checkpoint would go unread there."""
    from tpu_splat_torch.config import build_parser, save_cfg_args
    from tpu_splat_torch.model.io import save_checkpoint, save_ply

    model, ck = str(root / "m"), str(root / "ck")
    save_cfg_args(model, _train_flags(src, model))
    save_ply(state, os.path.join(model, "point_cloud", f"iteration_{ITERATION}",
                                 "point_cloud.ply"))
    save_cfg_args(ck, build_parser().parse_args(["-s", src, "-m", ck, "--eval"]))
    save_checkpoint(os.path.join(ck, f"chkpnt{CK_ITERATION}.npz"), ts, CK_ITERATION)
    return model, ck


def _build_model(src):
    """300 surfels from a seed, opacity / reflection logits spread so the
    reflection and the alpha test matter, and an ISP moved off identity."""
    import dataclasses

    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.model.state import init_from_pcd
    from tpu_splat_torch.train.step import TrainState

    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (N_GAUSS, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (N_GAUSS, 3)).astype(np.float32)
    state = init_from_pcd(pts, cols, capacity=N_GAUSS, cubemap_resolution=8, device="cpu")
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    state = dataclasses.replace(
        state, opacity=f(N_GAUSS, 1) * 2.0, refl=f(N_GAUSS, 1) * 2.0 - 1.0,
        features_rest=f(*state.features_rest.shape) * 0.1, active_sh_degree=3,
        env=state.env._replace(texture=f(*state.env.texture.shape) * 0.5))
    ts = TrainState.create(state, OptimizationParams(), num_frames=4)
    isp = ts.isp
    ts = dataclasses.replace(ts, isp=isp._replace(
        gain=isp.gain + f(*isp.gain.shape) * 0.1, bias=f(*isp.bias.shape) * 0.05,
        log_gamma=f(*isp.log_gamma.shape) * 0.1, ctrl_gain=isp.ctrl_gain + f(3, 3) * 0.1,
        ctrl_bias=f(3) * 0.05, ctrl_log_gamma=f(3) * 0.1, vig_coef=f(1, 2) * 0.2,
        vig_center=f(1, 2) * 0.05))
    return state, ts


def _write_gt_normals(src):
    """A smooth GT normal map for the test view r_0 (eval_mae's input)."""
    y, x = np.mgrid[0:SCENE_SIZE, 0:SCENE_SIZE] / SCENE_SIZE - 0.5
    n = np.stack([x, y, np.full_like(x, 0.8)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    os.makedirs(os.path.join(src, "normals"))
    Image.fromarray(((n * 0.5 + 0.5) * 255 + 0.5).astype(np.uint8)).save(
        os.path.join(src, "normals", "r_0.png"))


CLI_RUNS = [
    ("render", ["--save_normals", "--save_refl"]),
    ("metrics", []),
    ("eval_fps", ["--repeats", "2"]),
    # the JAX CLI reads args.gt_normals_dir, which a train-CLI cfg_args
    # lacks: without the flag it raises AttributeError
    ("eval_mae", ["--gt_normals_dir", "{src}/normals"]),
    ("visible_gaussians", ["--iteration", str(ITERATION)]),
    ("render_videos", ["--iteration", str(ITERATION), "--render_path",
                       "--n_frames", str(N_FRAMES)]),
    ("video", ["--iteration", str(ITERATION), "--n_frames", str(N_FRAMES)]),
    ("view_diff_maps", []),
    ("report", ["--iteration", str(ITERATION)]),
]
# numpy-only CLIs that take the model's parent as --output_path
TREE_RUNS = ("extract_metrics", "collect_results")


def _run_clis(pkg, model, ck, src, device):
    import importlib

    kw = {} if device is None else {"device": device}
    for name, extra in CLI_RUNS:
        mod = importlib.import_module(f"{pkg}.scripts.{name}")
        mod.main(["-m", model, *(a.format(src=src) for a in extra)], **kw)
    for name in TREE_RUNS:
        mod = importlib.import_module(f"{pkg}.scripts.{name}")
        mod.main(["--output_path", os.path.dirname(model), "--scenes",
                  os.path.basename(model)])
    render = importlib.import_module(f"{pkg}.scripts.render")
    render.main(["-m", ck, "--start_checkpoint",
                 os.path.join(ck, f"chkpnt{CK_ITERATION}.npz")], **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    src = str(root / "scene")
    _make_scene(src, n=N_VIEWS, size=SCENE_SIZE)
    _write_gt_normals(src)
    state, ts = _build_model(src)
    out = {"src": src}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TORCH_HOME", str(root / "torch_home"))  # no LPIPS weights
        mp.delenv("LPIPS_WEIGHTS", raising=False)
        for pkg, device in (("tpu_splat_torch", "cpu"), ("tpu_splat", None)):
            tree = root / pkg
            tree.mkdir()
            model, ck = _model_dirs(tree, src, state, ts)
            if device is None:
                _jax_rendering(mp)
            _run_clis(pkg, model, ck, src, device)
            out[pkg] = tree
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_port_writes_the_files_the_jax_clis_write(runs):
    assert _files(runs["tpu_splat_torch"]) == _files(runs["tpu_splat"])


def _rgb(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int16)


@pytest.mark.parametrize("pattern", [
    "m/env_cood*.png", "m/*/ours_7/renders/*.png", "m/*/ours_7/normals/*.png",
    "m/*/ours_7/refl/*.png", "ck/*/ours_5/renders/*.png", "m/traj/ours_7/renders/*.png",
    "m/traj/ours_7/depth/*.png", "m/traj/ours_7/0*.png", "m/test/ours_7/diff_maps/*.png",
    "m/*/ours_7/gt/*.png", "ck/*/ours_5/gt/*.png",
])
def test_pngs_match_jax(runs, pattern):
    port, jax_ = runs["tpu_splat_torch"], runs["tpu_splat"]
    names = sorted(glob.glob(pattern, root_dir=port))
    assert names and names == sorted(glob.glob(pattern, root_dir=jax_))
    for name in names:
        got, want = _rgb(os.path.join(port, name)), _rgb(os.path.join(jax_, name))
        assert got.shape == want.shape, name
        off = np.abs(got - want).max(-1)
        if "/gt/" in name:
            assert not off.any(), name
        else:
            assert off.max() <= 1, (name, int(off.max()))
            assert int((off > 0).sum()) <= FLIPS_PER_4096 * off.size / 4096, name


def test_checkpoint_renders_apply_the_isp(runs):
    """The checkpoint holds the PLY's Gaussians: its renders differ only by
    the ISP (per-frame on train views, the controller on the test view)."""
    port = runs["tpu_splat_torch"]
    for split in ("train", "test"):
        for name in os.listdir(os.path.join(port, "m", split, "ours_7", "renders")):
            a = _rgb(os.path.join(port, "m", split, "ours_7", "renders", name))
            b = _rgb(os.path.join(port, "ck", split, "ours_5", "renders", name))
            assert np.abs(a - b).max() > 8, (split, name)


def test_metrics_match_jax_on_one_directory(runs, tmp_path, monkeypatch):
    """The port's metrics CLI on the PNGs the JAX CLIs wrote, against the
    JAX metrics CLI's results on them."""
    from tpu_splat_torch.scripts import metrics

    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    jax_ = os.path.join(runs["tpu_splat"], "m")
    shutil.copytree(os.path.join(jax_, "test"), tmp_path / "q" / "test")
    metrics.main(["-m", str(tmp_path / "q")], device="cpu")
    for f in ("results.json", "per_view.json"):
        with open(tmp_path / "q" / f) as fh:
            got = json.load(fh)
        with open(os.path.join(jax_, f)) as fh:
            want = json.load(fh)
        assert list(got) == list(want) == ["ours_7"]
        assert list(got["ours_7"]) == list(want["ours_7"])
    with open(tmp_path / "q" / "results.json") as fh:
        got = json.load(fh)["ours_7"]
    with open(os.path.join(jax_, "results.json")) as fh:
        want = json.load(fh)["ours_7"]
    assert abs(got["PSNR"] - want["PSNR"]) <= 1e-4, (got, want)
    assert abs(got["SSIM"] - want["SSIM"]) <= 1e-5, (got, want)
    assert got["GMSD"] == want["GMSD"]
    assert math.isnan(got["LPIPS"]) and math.isnan(want["LPIPS"])
    assert got["LPIPS_METRIC"] == want["LPIPS_METRIC"] == "unavailable (NaN)"


def _lines(path):
    with open(path) as f:
        return f.read().split()


def test_counts_match_jax(runs):
    from tpu_splat_torch.model.io import load_envmap

    port, jax_ = (os.path.join(runs[k], "m") for k in ("tpu_splat_torch", "tpu_splat"))
    visible, total = map(int, _lines(os.path.join(port, "visible.txt")))
    assert _lines(os.path.join(port, "visible.txt")) == _lines(os.path.join(jax_, "visible.txt"))
    assert 0 < visible <= total == N_GAUSS
    fps, count = _lines(os.path.join(port, "fps.txt"))
    assert float(fps) > 0 and count == _lines(os.path.join(jax_, "fps.txt"))[1] == str(N_GAUSS)
    vis = os.path.join("point_cloud", f"iteration_{ITERATION}_visible", "point_cloud")
    for ext in (".ply", ".map.npz"):
        with open(os.path.join(port, vis + ext), "rb") as a, open(os.path.join(jax_, vis + ext), "rb") as b:
            assert a.read() == b.read(), ext
    a, b = (load_envmap(os.path.join(d, vis + ".map"), device="cpu") for d in (port, jax_))
    assert torch.equal(a.texture, b.texture) and torch.equal(a.fail_value, b.fail_value)


def test_mae_matches_jax(runs):
    port, jax_ = (os.path.join(runs[k], "m", "mae.txt") for k in ("tpu_splat_torch", "tpu_splat"))
    got, want = float(_lines(port)[0]), float(_lines(jax_)[0])
    assert abs(got - want) <= 1e-3, (got, want)


def test_reports_match_jax(runs):
    port, jax_ = runs["tpu_splat_torch"], runs["tpu_splat"]
    with open(os.path.join(port, "m", "stats.json")) as a, open(os.path.join(jax_, "m", "stats.json")) as b:
        assert json.load(a) == json.load(b)
    for f in ("results.csv", "results_all.csv"):
        rows = [[line.split("\t") for line in open(os.path.join(d, f)).read().splitlines()]
                for d in (port, jax_)]
        assert [len(r) for r in rows[0]] == [len(r) for r in rows[1]], f
        assert rows[0][0] == rows[1][0], f
    got = open(os.path.join(port, "results_all.csv")).read().splitlines()[1].split("\t")
    assert got[0] == "m" and got[-1] == str(N_GAUSS)


def test_find_max_iteration_raises_on_the_visible_dir(runs):
    """Both packages parse every iteration_* entry as a number, so the
    directory visible_gaussians writes makes them raise."""
    from tpu_splat.scripts.render import find_max_iteration as j_find

    from tpu_splat_torch.scripts.render import find_max_iteration as t_find

    for find, key in ((t_find, "tpu_splat_torch"), (j_find, "tpu_splat")):
        with pytest.raises(ValueError):
            find(os.path.join(runs[key], "m"))


@pytest.mark.parametrize("skips", [("--skip_training", "--skip_rendering"), ("--skip_training",)])
def test_full_eval_builds_port_command_lines(tmp_path, monkeypatch, skips):
    """full_eval on an empty output dir: the same stages as the JAX full_eval,
    each `python -m tpu_splat_torch.scripts.<stage>`, with the flag bundles
    of the repository's scene_args.yaml."""
    from tpu_splat.scripts import full_eval as jfe

    from tpu_splat_torch.scripts import full_eval as tfe

    cmds = {}
    for name, mod in (("port", tfe), ("jax", jfe)):
        seen = cmds[name] = []
        monkeypatch.setattr(mod, "run", lambda cmd, log=None, seen=seen: seen.append(cmd) or 0)
        out = str(tmp_path / name)
        assert mod.main(["--base_dir", str(tmp_path / "data"), "--output_path", out,
                         "--scenes", "nerf_synthetic/lego", *skips]) == 0
    assert cmds["port"] and len(cmds["port"]) == len(cmds["jax"])
    for got, want in zip(cmds["port"], cmds["jax"]):
        assert got[1:3] == ["-m", want[2].replace("tpu_splat.", "tpu_splat_torch.", 1)]
        assert got[3:] == [w.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for w in want[3:]]
    stages = [c[2].rsplit(".", 1)[1] for c in cmds["port"]]
    assert stages == (["metrics", "collect_results"] if "--skip_rendering" in skips
                      else ["render", "eval_fps", "metrics", "collect_results"])


def test_full_report_runs_the_port_report(runs, monkeypatch):
    from tpu_splat_torch.scripts import full_report

    seen = []
    monkeypatch.setattr(full_report.subprocess, "call", lambda cmd: seen.append(cmd) or 0)
    port = str(runs["tpu_splat_torch"])
    assert full_report.main(["--output_path", port, "--scenes", "m"]) == 0
    assert seen == [[full_report.sys.executable, "-m", "tpu_splat_torch.scripts.report",
                     "-m", os.path.join(port, "m")]]
