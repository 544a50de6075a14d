"""The port's tile-sharded paths over 2 and 4 gloo ranks on the CPU, against
the JAX package's `make_mesh(n)` on the conftest's virtual CPU devices.

At 48x48 (3 tile rows: 2 ranks leave one padding row, 4 ranks a padding
slab and an empty rank) the port's ranks (tests/torch_dist_worker.py,
started by `tpu_splat_torch.dist.launch`) run:
- the tile-sharded rasterizer under the production switches with all
  channels, against JAX `rasterize(mesh=...)` (backend="pallas", its
  kernels in interpret mode): colour and alpha 2e-5, n_contrib exact,
  num_instances (in global capacity units), the busiest tile and
  pad_overflow equal; gaussian_weights within 1e-6 of each package's
  unsharded rasterizer, and apart from the JAX package's by no more than
  the unsharded port is (on this scene up to 2.3e-5, at the edge-on
  Gaussian 68, where the port is the nearer to float64:
  tests/test_torch_witness.py::test_gaussian_weights_gap_is_an_edge_on_splat);
- the tile-sharded training step with the ISP and env scope on, in the
  deferred-reflection stage, at 42x48 (at 4 ranks the env pass pads its
  pixel rows too) under the exact switches, against the loss function of
  JAX `make_train_step(mesh=...)`: the loss terms 1e-5 relative, the
  rendered image 2e-5, every gradient 1e-3 of its leaf's max (edge-on
  rows 1.5e-3, as tests/test_torch_train.py holds the unsharded step);
- the scan blend (backend="xla") with the mesh against the port's own
  unsharded scan: colour and maps 2e-5, n_contrib exact, gradients 1e-5 of
  each leaf's max; and the kernel path's blend-only mesh branch
  (`blend_kernel_path(mesh=...)`) against its unsharded call: the maps and
  gaussian_weights equal, gradients 1e-6 of each leaf's max (each slab
  row's gradient comes from one rank, the others add zeros).
Every rank's parameters after the step are bit-identical. Then the host
camera partition and `multihost_init` against the JAX functions, and the
port's `dryrun_multichip(2)`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_train import (
    BG,
    FRAME,
    ISP_CFG,
    KW,
    _camera_arrays,
    _jax_train_state,
    _scene,
    _ts_to_numpy,
)
from tests import torch_dist_worker
from tpu_splat.config import OptimizationParams
from tpu_splat.data import orbit_camera
from tpu_splat.dist import make_mesh
from tpu_splat.dist import mesh as jmesh
from tpu_splat.isp import ppisp as jisp
from tpu_splat.raster import rasterize
from tpu_splat.raster.config import production_config
from tpu_splat.train.step import make_train_step

from tpu_splat_torch import dist as tdist
from tpu_splat_torch.dist import mesh as tmesh

NS = (2, 4)
SCOPE = dict(scope_center=(0.1, -0.1, 0.0), scope_radius=0.9)
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl")


@pytest.fixture(scope="module")
def inputs():
    d = _scene()
    jts = _jax_train_state(d).replace(step=jnp.asarray(600, jnp.int32))
    cam_r = orbit_camera(48, 48, radius=4.0, azimuth=0.4, elevation=0.3)
    cam_s = orbit_camera(42, 48, radius=4.0, azimuth=0.5, elevation=0.25)
    gt = np.random.default_rng(1).uniform(0, 1, (42, 48, 3)).astype(np.float32)
    return dict(jts=jts, cam_r=cam_r, cam_s=cam_s, port=dict(
        ts=_ts_to_numpy(jts), cam_render=_camera_arrays(cam_r), cam_step=_camera_arrays(cam_s),
        gt=gt, bg=np.asarray(BG, np.float32), kw=KW, frame=FRAME, isp_cfg=ISP_CFG, **SCOPE))


@pytest.fixture(scope="module")
def both(inputs):
    """(the port's rank-ordered results of `tiles_cases` at each mesh size,
    the JAX references); the ranks' processes run while the JAX side
    compiles, each JAX mesh size in a thread of its own."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2 * len(NS) + 1) as pool:
        port = {n: pool.submit(tdist.launch, torch_dist_worker.tiles_cases, n,
                               args=(n, inputs["port"]), backend="gloo") for n in NS}
        refs = {n: pool.submit(_jax_ref, inputs, n) for n in (1, *NS)}
        refs = {("raster_single" if n == 1 else n): f.result() for n, f in refs.items()}
        return {n: f.result() for n, f in port.items()}, refs


@pytest.fixture(scope="module")
def port(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_refs(both):
    return both[1]


def _jax_ref(inputs, n):
    """JAX `rasterize(mesh=...)` and the loss function of
    `make_train_step(mesh=...)` over `make_mesh(n)`; n = 1: the unsharded
    rasterizer."""
    jts, bg = inputs["jts"], jnp.asarray(BG)
    g = jts.gaussians
    cfg = production_config(backend="pallas", grad_channels="full", **KW)
    mesh = None if n == 1 else make_mesh(n)
    o = jax.jit(lambda s: rasterize(
        s.xyz, s.get_scaling(), s.rotation, s.get_opacity(), s.get_refl(),
        inputs["cam_r"], bg, cfg, sh=s.get_features(), sh_degree=s.max_sh_degree,
        alive=s.alive, mesh=mesh))(g)
    if n == 1:
        return o
    jstep = make_train_step(
        OptimizationParams(), production_config(backend="pallas", bf16_grads=False,
                                                bf16_feats=False, **KW),
        1.0, use_env_scope=True, env_scope_center=SCOPE["scope_center"],
        env_scope_radius=SCOPE["scope_radius"], isp_cfg=jisp.ISPConfig(**ISP_CFG),
        mesh=mesh)
    params = {**g.param_pytree(), **{f"isp_{k}": v for k, v in jts.isp._asdict().items()}}
    (loss, (jout, l1, ssim_v, normal_loss, _)), (jg, jgso) = jax.jit(jax.value_and_grad(
        jstep._loss_fn, argnums=(0, 1), has_aux=True
    ))(params, jnp.zeros((g.capacity, 2)), g, inputs["cam_s"],
       jnp.asarray(inputs["port"]["gt"]), None, bg, jnp.asarray(False),
       jnp.asarray(FRAME, jnp.int32), jnp.asarray(False))
    grads = {k: np.asarray(v) for k, v in jg.items()}
    grads["screen_offset"] = np.asarray(jgso)
    return dict(
        raster=o, grads=grads, render=np.asarray(jout.render),
        loss=dict(loss=float(loss), l1=float(l1), ssim=float(ssim_v),
                  normal_loss=float(normal_loss)))


@pytest.mark.parametrize("n", NS)
def test_sharded_render_matches_jax(port, jax_refs, n):
    j = jax_refs[n]["raster"]
    j_gw, j1_gw = np.asarray(j.gaussian_weights), np.asarray(
        jax_refs["raster_single"].gaussian_weights)
    np.testing.assert_allclose(j_gw, j1_gw, rtol=0, atol=1e-6)
    for rank, res in enumerate(port[n]):
        t = res["render"]
        np.testing.assert_allclose(t["color"], np.asarray(j.color), rtol=0, atol=2e-5)
        np.testing.assert_allclose(t["alpha"], np.asarray(j.others)[..., 1], rtol=0, atol=2e-5)
        np.testing.assert_array_equal(t["n_contrib"], np.asarray(j.n_contrib))
        np.testing.assert_allclose(t["gw"], res["render_single"]["gw"], rtol=0, atol=1e-6)
        unsharded = np.abs(res["render_single"]["gw"] - j1_gw)
        assert (np.abs(t["gw"] - j_gw) <= unsharded + 1e-6).all(), rank
        assert int(t["num_instances"]) == int(j.num_instances), rank
        assert int(t["max_tile"]) == int(np.asarray(j.tile_counts).max()), rank
        assert int(t["pad_overflow"]) == int(j.pad_overflow), rank
    assert np.asarray(j.n_contrib).max() > 1 and float(np.asarray(j.others)[..., 1].max()) > 0.5


def _edge_on(inputs):
    """Gaussians seen nearly edge-on from the step's camera (as
    tests/test_torch_train.py:_edge_on defines them)."""
    from tpu_splat_torch.model.convert import camera_from_numpy, train_state_from_numpy
    from tpu_splat_torch.raster.preprocess import preprocess

    g = train_state_from_numpy(inputs["port"]["ts"], device="cpu").gaussians
    c = camera_from_numpy(inputs["port"]["cam_step"], device="cpu")
    hom = preprocess(g.xyz, g.get_scaling(), g.rotation, c.world_view, c.full_proj,
                     c.camera_center, c.height, c.width,
                     colors=torch.zeros((g.capacity, 3))).hom.double().numpy()
    ratio = np.abs(np.linalg.det(hom)) / np.prod(np.linalg.norm(hom, axis=-1), axis=-1)
    return ratio < 2.0**-24 / 1e-3


@pytest.mark.parametrize("n", NS)
def test_sharded_step_matches_jax(port, jax_refs, inputs, n):
    ref = jax_refs[n]
    ill = _edge_on(inputs)
    assert ill.sum() <= len(ill) / 40
    for rank, res in enumerate(port[n]):
        s = res["step"]
        for f, want in ref["loss"].items():
            assert abs(s["loss"][f] - want) <= 1e-5 * abs(want), (rank, f, s["loss"][f], want)
        np.testing.assert_allclose(s["render"], ref["render"], rtol=0, atol=2e-5)
        for k, want in ref["grads"].items():
            got = s["grads"][k]
            scale = np.abs(want).max()
            err = np.abs(got - want)
            if k == "env_fail":  # no pixel reflects a zero direction
                assert scale == 0.0 and err.max() == 0.0
                continue
            assert scale > 0, k  # ISP, env map, scope loss: every other leaf is live
            if k in LEAVES or k == "screen_offset":
                assert err[ill].max(initial=0.0) <= 1.5e-3 * scale, (rank, k, "edge-on")
                err = err[~ill]
            assert err.max() <= 1e-3 * scale, (rank, k, float(err.max() / scale))


@pytest.mark.parametrize("n", NS)
def test_sharded_replicas_bit_identical(port, n):
    """Every rank ends the step with the same parameters, moments and
    statistics, bit for bit, and the same diagnostics."""
    first = port[n][0]["step"]
    for res in port[n][1:]:
        s = res["step"]
        assert s["diag"] == first["diag"] and s["loss"] == first["loss"]
        for part in ("params", "mu", "nu", "stats"):
            for k, v in first[part].items():
                np.testing.assert_array_equal(s[part][k], v, err_msg=f"{part}.{k}")


@pytest.mark.parametrize("n", NS)
def test_sharded_scan_blend_matches_single(port, n):
    for res in port[n]:
        a, b = res["scan_single"], res["scan_sharded"]
        for f in ("color", "others"):
            np.testing.assert_allclose(b[f], a[f], rtol=0, atol=2e-5, err_msg=f)
        np.testing.assert_array_equal(b["n_contrib"], a["n_contrib"])
        np.testing.assert_array_equal(b["gw"], a["gw"])
        for k, want in a["grads"].items():
            # refl and the env map do not reach the base colour and distortion
            assert np.abs(b["grads"][k] - want).max() <= 1e-5 * np.abs(want).max(), k
        assert np.abs(a["grads"]["xyz"]).max() > 0


@pytest.mark.parametrize("n", NS)
def test_sharded_blend_kernel_path_matches_single(port, n):
    for res in port[n]:
        a, b = res["blend_single"], res["blend_sharded"]
        for f in ("color", "others", "gw"):
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        for k, want in a["grads"].items():
            assert np.abs(b["grads"][k] - want).max() <= 1e-6 * np.abs(want).max(), k
        assert np.abs(a["grads"]["xyz"]).max() > 0


def test_host_camera_partition_matches_jax():
    for n_cam, n_host in [(7, 2), (48, 2), (48, 4), (5, 4), (3, 4)]:
        for p in range(n_host):
            np.testing.assert_array_equal(tmesh.host_camera_indices(n_cam, p, n_host),
                                          jmesh.host_camera_indices(n_cam, p, n_host))
            for epoch in (0, 3):
                np.testing.assert_array_equal(
                    tmesh.host_epoch_permutation(n_cam, epoch, p, n_host),
                    jmesh.host_epoch_permutation(n_cam, epoch, p, n_host))
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError):
            mod.host_camera_indices(10, 2, 2)


def test_multihost_init_topology_and_noop(monkeypatch):
    """An explicit topology initialises against the coordinator and lets a
    failure raise; without configuration it is a no-op returning (0, 1)."""
    calls = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None, **kw):
        calls.update(backend=backend, init=init_method, n=world_size, pid=rank)

    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tmesh.dist, "init_process_group", fake_init)
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: 2)
    assert tmesh.multihost_init("10.0.0.1:1234", num_processes=2, process_id=1,
                                backend="gloo") == (1, 2)
    assert calls == dict(backend="gloo", init="tcp://10.0.0.1:1234", n=2, pid=1)

    def failing_init(*a, **kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(tmesh.dist, "init_process_group", failing_init)
    with pytest.raises(RuntimeError, match="unreachable"):
        tmesh.multihost_init("10.0.0.1:1234", num_processes=2, process_id=0)
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    assert tmesh.multihost_init() == (0, 1)
    mesh = tmesh.make_mesh()
    assert (mesh.axis, mesh.size, mesh.rank, mesh.group) == ("tiles", 1, 0, None)


def test_dryrun_multichip_two_ranks():
    from tpu_splat_torch import graft_entry

    out = graft_entry.dryrun_multichip(2, device="cpu")
    for mode in ("tiles", "dp"):
        assert np.isfinite(out[mode]["loss"]) and out[mode]["instances"] > 0, mode
