"""Model files across the two packages, on the CPU: the PLY snapshot (byte
equal), the `.map.npz` and torch `.map` cubemap sidecars, the training
checkpoint and `cfg_args`, each written by one package and read by the
other, in both directions, with every array bit equal. Also the port's
list of the JAX TrainState's leaves against a real `jax.tree.flatten`.

Fixtures: artifacts/valid_scratch_state.{ply,map,map.npz} (12,837 surfels,
SH degree 3, 64^2 cubemap) and a small JAX TrainState with the ISP on and
moments, statistics, step and count that are not their initial values.
"""
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.config import OptimizationParams as JOpt
from tpu_splat.config import build_parser as j_build_parser
from tpu_splat.config import get_combined_args as j_get_combined_args
from tpu_splat.config import save_cfg_args as j_save_cfg_args
from tpu_splat.envmap.cubemap import CubemapParams
from tpu_splat.model import io as jio
from tpu_splat.model.state import GaussianState
from tpu_splat.model.torch_pickle import load_torch_state_dict as j_load_torch
from tpu_splat.model.torch_pickle import save_torch_state_dict as j_save_torch
from tpu_splat.train.step import TrainState

from tpu_splat_torch import config as tconfig
from tpu_splat_torch.model import convert
from tpu_splat_torch.model import io as tio
from tpu_splat_torch.model import torch_pickle as ttp

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts")
PLY = os.path.join(ART, "valid_scratch_state.ply")
CAP, N_ALIVE = 96, 80
GFIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl",
           "alive")


def _bits(a):
    a = np.asarray(a)
    return a.reshape(-1).view(np.uint8) if a.dtype != bool else a


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _states_equal(t, j):
    """A port GaussianState against a JAX one, bit for bit."""
    for f in GFIELDS:
        _eq(_host(getattr(t, f)), np.asarray(getattr(j, f)), f)
    _eq(_host(t.env.texture), np.asarray(j.env.texture), "texture")
    _eq(_host(t.env.fail_value), np.asarray(j.env.fail_value), "fail_value")
    assert int(t.active_sh_degree) == int(j.active_sh_degree)
    assert t.max_sh_degree == j.max_sh_degree


def _jax_train_state(isp: bool):
    rng = np.random.default_rng(4)
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))
    g = GaussianState(
        xyz=f(CAP, 3), features_dc=f(CAP, 1, 3), features_rest=f(CAP, 3, 3),
        scaling=f(CAP, 2), rotation=f(CAP, 4), opacity=f(CAP, 1), refl=f(CAP, 1),
        env=CubemapParams(f(6, 3, 8, 8), f(3)),
        alive=jnp.asarray(np.arange(CAP) < N_ALIVE),
        active_sh_degree=jnp.asarray(1, jnp.int32), max_sh_degree=1,
    )
    ts = TrainState.create(g, JOpt(), seed=0, num_frames=3 if isp else None)
    moved = lambda tree: jax.tree.map(lambda v: v + f(*v.shape), tree)
    opt = ts.opt._replace(mu=moved(ts.opt.mu), nu=moved(ts.opt.nu),
                          count=jnp.asarray(17, jnp.int32))
    ts = ts.replace(opt=opt, stats=moved(ts.stats), step=jnp.asarray(17, jnp.int32),
                    opacity_lr=jnp.asarray(0.0123, jnp.float32))
    if isp:
        ts = ts.replace(isp=moved(ts.isp))
    return ts


def _port_train_state(jts):
    """The port's TrainState holding the JAX one's arrays (through the
    JAX leaves, in the port's leaf order)."""
    leaves = dict(zip(convert.train_state_leaf_names(jts.isp is not None),
                      (np.asarray(l) for l in jax.tree.leaves(jts))))
    return convert.train_state_from_leaves(leaves, jts.gaussians.max_sh_degree, device="cpu")


@pytest.fixture(scope="module")
def jstates():
    return {isp: _jax_train_state(isp) for isp in (False, True)}


@pytest.mark.parametrize("isp", [False, True])
def test_leaf_order_matches_jax_tree_flatten(jstates, isp):
    jts = jstates[isp]
    jleaves = jax.tree.leaves(jts)
    names = convert.train_state_leaf_names(isp)
    assert len(names) == len(jleaves)
    # the port's state built from the leaves gives them back, in order and
    # in the JAX dtypes
    got = convert.train_state_to_leaves(_port_train_state(jts))
    assert list(got) == names
    for name, g, w in zip(names, got.values(), jleaves):
        _eq(g, np.asarray(w), name)
    # and each name points at the leaf of that name
    assert np.asarray(jts.opt.mu["isp_gain" if isp else "xyz"]).shape == \
        got["opt.mu." + ("isp_gain" if isp else "xyz")].shape


@pytest.mark.parametrize("seed", [0, 1, 42, -5, 2**31 + 5, 2**40 + 3])
def test_prng_key_bits_match_jax(seed):
    _eq(convert.prng_key_bits(seed), np.asarray(jax.random.PRNGKey(seed)), str(seed))


@pytest.fixture(scope="module")
def fixture_state():
    return jio.load_ply(PLY)


def test_ply_fixture_loads_alike(fixture_state):
    t = tio.load_ply(PLY, device="cpu")
    _states_equal(t, fixture_state)
    t = tio.load_ply(PLY, capacity=13_000, device="cpu")
    _states_equal(t, jio.load_ply(PLY, capacity=13_000))


def test_ply_bytes_equal_both_ways(tmp_path, fixture_state):
    jp, tp = str(tmp_path / "j" / "p.ply"), str(tmp_path / "t" / "p.ply")
    jio.save_ply(fixture_state, jp)
    tio.save_ply(tio.load_ply(PLY, device="cpu"), tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    # the port's files load in the JAX package (its sidecar included)
    _states_equal(tio.load_ply(jp, device="cpu"), jio.load_ply(tp))
    for ext in (".map.npz", ".map"):
        e = jio.load_envmap(tp.replace(".ply", ext))
        _eq(np.asarray(e.texture), np.asarray(fixture_state.env.texture), ext)
        _eq(np.asarray(e.fail_value), np.asarray(fixture_state.env.fail_value), ext)


@pytest.mark.parametrize("ext", [".map.npz", ".map"])
def test_envmap_sidecars_both_ways(tmp_path, ext):
    want = jio.load_envmap(os.path.join(ART, "valid_scratch_state" + ext))
    # JAX-written fixture -> port
    got = tio.load_envmap(os.path.join(ART, "valid_scratch_state" + ext), device="cpu")
    _eq(_host(got.texture), np.asarray(want.texture))
    _eq(_host(got.fail_value), np.asarray(want.fail_value))
    # port writes -> JAX reads; JAX writes -> port reads
    tp, jp = str(tmp_path / ("t" + ext)), str(tmp_path / ("j" + ext))
    (tio.save_envmap if ext == ".map.npz" else tio.save_envmap_torch)(got, tp)
    (jio.save_envmap if ext == ".map.npz" else jio.save_envmap_torch)(want, jp)
    for a, b in ((jio.load_envmap(tp), want), (tio.load_envmap(jp, device="cpu"), want)):
        _eq(_host(a.texture), np.asarray(b.texture), ext)
        _eq(_host(a.fail_value), np.asarray(b.fail_value), ext)


def test_torch_state_dict_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    d = {"a": rng.normal(size=(2, 3, 4)).astype(np.float32),
         "b": rng.integers(-9, 9, 5).astype(np.int64), "c": np.float32(1.5) * np.ones(1, np.float32)}
    ttp.save_torch_state_dict(str(tmp_path / "t.map"), d)
    j_save_torch(str(tmp_path / "j.map"), d)
    for got in (j_load_torch(str(tmp_path / "t.map")), ttp.load_torch_state_dict(str(tmp_path / "j.map"))):
        assert set(got) == set(d)
        for k in d:
            _eq(got[k], d[k], k)


@pytest.mark.parametrize("isp", [False, True])
def test_checkpoint_jax_to_port(tmp_path, jstates, isp):
    jts = jstates[isp]
    path = str(tmp_path / "j.npz")
    jio.save_checkpoint(path, jts, 17)
    template = _port_train_state(_jax_train_state(isp))
    ts, it = tio.load_checkpoint(path, template)
    assert it == 17
    got = convert.train_state_to_leaves(ts)
    for (name, g), w in zip(got.items(), jax.tree.leaves(jts)):
        _eq(g, np.asarray(w), name)
    # a JAX checkpoint carries no generator: seeded as TrainState.create
    assert torch.equal(ts.generator.get_state(), torch.Generator().manual_seed(0).get_state())
    g, it = tio.load_checkpoint_gaussians(path, device="cpu")
    _states_equal(g, jts.gaussians)
    isp_t = tio.load_checkpoint_isp(path, device="cpu")
    assert (isp_t is None) == (not isp)
    if isp:
        for k, v in jts.isp._asdict().items():
            _eq(_host(getattr(isp_t, k)), np.asarray(v), k)


@pytest.mark.parametrize("isp", [False, True])
def test_checkpoint_port_to_jax(tmp_path, jstates, isp):
    jts = jstates[isp]
    ts = _port_train_state(jts)
    torch.randn(3, generator=ts.generator)  # a generator that has drawn
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, ts, 23)
    back, it = jio.load_checkpoint(path, _jax_train_state(isp))
    assert it == 23
    for name, g, w in zip(convert.train_state_leaf_names(isp), jax.tree.leaves(back),
                          jax.tree.leaves(jts.replace(key=jax.random.PRNGKey(0)))):
        _eq(np.asarray(g), np.asarray(w), name)
    g, it = jio.load_checkpoint_gaussians(path)
    assert it == 23
    _states_equal(ts.gaussians, g)
    jisp = jio.load_checkpoint_isp(path)
    assert (jisp is None) == (not isp)
    if isp:
        for k, v in jts.isp._asdict().items():
            _eq(np.asarray(getattr(jisp, k)), np.asarray(v), k)
    # the port resumes its own generator
    ts2, _ = tio.load_checkpoint(path, ts)
    assert torch.equal(ts2.generator.get_state(), ts.generator.get_state())


def test_config_fields_match_jax():
    for jcls, tcls in ((__import__("tpu_splat.config", fromlist=["x"]).ModelParams,
                        tconfig.ModelParams),
                       (__import__("tpu_splat.config", fromlist=["x"]).PipelineParams,
                        tconfig.PipelineParams),
                       (JOpt, tconfig.OptimizationParams)):
        jf, tf = jcls(), tcls()
        assert [f.name for f in jcls.__dataclass_fields__.values()] == \
            [f.name for f in tcls.__dataclass_fields__.values()]
        for k in jcls.__dataclass_fields__:
            if k != "data_device":
                assert getattr(jf, k) == getattr(tf, k), k
    assert tconfig.ModelParams().data_device == "cuda"
    argv = ["-s", "/data/lego", "-m", "/tmp/m", "--iterations", "100", "-w", "-r", "2",
            "--normal_propagation"]
    t, j = (vars(p().parse_args(argv)) for p in (tconfig.build_parser, j_build_parser))
    assert t.pop("data_device") == "cuda" and j.pop("data_device") == "tpu"
    assert t == j


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cfg_args_both_ways(tmp_path, writer):
    argv = ["-s", "/data/lego", "-m", str(tmp_path), "--iterations", "100", "-w",
            "--lambda_normal", "0.1"]
    save, parser = ((tconfig.save_cfg_args, tconfig.build_parser) if writer == "port"
                    else (j_save_cfg_args, j_build_parser))
    save(str(tmp_path), parser().parse_args(argv))
    read = ["-m", str(tmp_path), "--sh_degree", "2"]
    t = tconfig.get_combined_args(tconfig.build_parser(fill_none_model=True), read)
    j = j_get_combined_args(j_build_parser(fill_none_model=True), read)
    assert vars(t) == vars(j)
    assert t.source_path == "/data/lego" and t.iterations == 100 and t.white_background
