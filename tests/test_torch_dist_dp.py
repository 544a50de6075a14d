"""The port's camera-DP step over 2 gloo ranks on the CPU, against the JAX
package's `make_train_step_dp` on `make_mesh(n, axis="dp")` over the
conftest's virtual CPU devices (4 ranks: tests/test_torch_dist_dp4.py, which
shares this module's helpers; a file a mesh size keeps each under a minute).

One DP step of n 48x48 cameras from the deferred-reflection stage with the
ISP and env scope on, under the exact switches (the JAX kernels in
interpret mode), and at 2 ranks one of mixed camera sizes (48x48 and
32x32) bucketed to 48x48 with loss masks. Held against the JAX step:
- the loss terms (each a mean over the ranks) 1e-5 relative, the
  diagnostics (maxed over the ranks) equal;
- the Adam moments mu and nu (mu is 0.1 of the mean gradient on a first
  step) within 1e-3 and 2e-3 of each leaf's max (rows of Gaussians seen
  edge-on from one of the cameras 1.5e-3 and 3e-3, as
  tests/test_torch_train.py holds the unsharded step);
- the new parameters equal within 1e-6 where the mean gradient's sign is
  settled (|g| over 1e-2 of its leaf's max: Adam's first update is
  lr * sign(g)), and within the update's size elsewhere;
- the densify statistics as B sequential `add_stats` would build them:
  counts and radii exact, the sums 1e-3 of their max (edge-on rows
  1.5e-3).
Every rank's state is bit-identical after the step and after the densify
event that follows it (tests/torch_dist_worker.py:dp_cases).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.test_torch_train import BG, ISP_CFG, KW, _camera_arrays, _jax_train_state, _scene
from tests.test_torch_train import _ts_to_numpy
from tests import torch_dist_worker
from tpu_splat.config import OptimizationParams
from tpu_splat.data import orbit_camera
from tpu_splat.dist import make_mesh
from tpu_splat.isp import ppisp as jisp
from tpu_splat.model.optim import default_lrs
from tpu_splat.raster.config import production_config
from tpu_splat.train.step import make_train_step_dp

from tpu_splat_torch import dist as tdist
from tpu_splat_torch.model.optim import param_group

H = W = 48
SCOPE = dict(scope_center=(0.1, -0.1, 0.0), scope_radius=0.9)
EXACT = dict(bf16_grads=False, bf16_feats=False, **KW)
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl")


def _cases(n, jts):
    rng = np.random.default_rng(n)
    cams = [orbit_camera(H, W, radius=4.0, azimuth=0.4 + 0.3 * i, elevation=0.3 - 0.05 * i)
            for i in range(n)]
    out = {"equal": dict(cams=cams, masks=None,
                         gts=[rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in cams])}
    if n == 2:
        sizes = [(H, W), (H - 16, W - 16)]
        cams0 = [orbit_camera(h, w, radius=4.0, azimuth=0.5 + 0.4 * i, elevation=0.25)
                 for i, (h, w) in enumerate(sizes)]
        gts = np.zeros((n, H, W, 3), np.float32)
        masks = np.zeros((n, H, W, 1), np.float32)
        for i, (h, w) in enumerate(sizes):
            gts[i, :h, :w] = rng.uniform(0, 1, (h, w, 3))
            masks[i, :h, :w] = 1.0
        # unify the static fov fields (the surfel path reads K and full_proj)
        cams = [c.pad_to(H, W).replace(fovx=cams0[0].fovx, fovy=cams0[0].fovy) for c in cams0]
        out["mixed"] = dict(cams=cams, masks=list(masks), gts=list(gts))
    for c in out.values():
        c["frames"] = [i % 2 for i in range(n)]
    return out


def build_refs(ns):
    """Per mesh size in ns: the JAX step's results, and the port's ranks'
    (their processes run while the JAX side compiles)."""
    from concurrent.futures import ThreadPoolExecutor

    jts = _jax_train_state(_scene()).replace(step=jnp.asarray(600, jnp.int32))
    old = {**jts.gaussians.param_pytree(),
           **{f"isp_{k}": v for k, v in jts.isp._asdict().items()}}
    cases = {n: _cases(n, jts) for n in ns}
    port_in = {n: dict(
        bg=np.asarray(BG, np.float32), cfg=EXACT, isp_cfg=ISP_CFG, densify_at=1000, **SCOPE,
        cases={name: dict(ts=_ts_to_numpy(jts), cams=[_camera_arrays(x) for x in c["cams"]],
                          gts=c["gts"], masks=c["masks"], frames=c["frames"])
               for name, c in cases[n].items()}) for n in ns}
    with ThreadPoolExecutor(len(ns)) as pool:
        port = {n: pool.submit(tdist.launch, torch_dist_worker.dp_cases, n,
                               args=(n, port_in[n]), backend="gloo") for n in ns}
        out = {}
        for n in ns:
            dp = jax.jit(make_train_step_dp(
                OptimizationParams(), production_config(backend="pallas", **EXACT), 1.0,
                mesh=make_mesh(n, axis="dp"), use_env_scope=True,
                env_scope_center=SCOPE["scope_center"], env_scope_radius=SCOPE["scope_radius"],
                isp_cfg=jisp.ISPConfig(**ISP_CFG)))
            jres = {}
            for name, c in cases[n].items():
                cam_b = jax.tree.map(lambda *xs: jnp.stack(xs), *c["cams"])
                masks = None if c["masks"] is None else jnp.asarray(np.stack(c["masks"]))
                new, aux = dp(jts, cam_b, jnp.asarray(np.stack(c["gts"])), jnp.asarray(BG),
                              frame_idx=jnp.asarray(c["frames"], jnp.int32), pix_masks=masks)
                params = {**new.gaussians.param_pytree(),
                          **{f"isp_{k}": v for k, v in new.isp._asdict().items()}}
                jres[name] = dict(new=_ts_to_numpy(new), aux=aux,
                                  params={k: np.asarray(v) for k, v in params.items()})
            out[n] = dict(jax=jres, old={k: np.asarray(v) for k, v in old.items()},
                          port_in=port_in[n],
                          cams={name: c["cams"] for name, c in cases[n].items()})
        for n in ns:
            out[n]["port"] = port[n].result()
    return out


@pytest.fixture(scope="module")
def refs():
    return build_refs((2,))


CASES = [(2, "equal"), (2, "mixed")]


def _edge_on(ts_numpy, cams):
    """Gaussians seen nearly edge-on from any of the cameras (as
    tests/test_torch_train.py:_edge_on defines them)."""
    import torch

    from tpu_splat_torch.model.convert import camera_from_numpy, train_state_from_numpy
    from tpu_splat_torch.raster.preprocess import preprocess

    g = train_state_from_numpy(ts_numpy, device="cpu").gaussians
    ill = np.zeros(g.capacity, bool)
    for cam in cams:
        c = camera_from_numpy(_camera_arrays(cam), device="cpu")
        hom = preprocess(g.xyz, g.get_scaling(), g.rotation, c.world_view, c.full_proj,
                         c.camera_center, c.height, c.width,
                         colors=torch.zeros((g.capacity, 3))).hom.double().numpy()
        ratio = np.abs(np.linalg.det(hom)) / np.prod(np.linalg.norm(hom, axis=-1), axis=-1)
        ill |= ratio < 2.0**-24 / 1e-3
    return ill


def _within(got, want, tol, ill=None, ill_tol=None):
    """|got - want| <= tol * max|want|, rows in `ill` <= ill_tol * max|want|."""
    scale = np.abs(want).max()
    err = np.abs(got - want)
    if ill is not None:
        assert err[ill].max(initial=0.0) <= ill_tol * scale
        err = err[~ill]
    return err.max(initial=0.0) <= tol * scale


def check_step(refs, n, case):
    """The port's ranks against the JAX DP step (the tolerances above)."""
    j = refs[n]["jax"][case]
    aux, new = j["aux"], j["new"]
    old, want_p = refs[n]["old"], j["params"]
    lrs = default_lrs(OptimizationParams(), 1.0)
    ill = _edge_on(refs[n]["port_in"]["cases"][case]["ts"], refs[n]["cams"][case])
    assert ill.sum() <= len(ill) / 20
    for rank, res in enumerate(refs[n]["port"]):
        t = res[case]
        for f in ("loss", "l1", "ssim", "normal_loss"):
            a = float(getattr(aux, f))
            assert abs(t["loss"][f] - a) <= 1e-5 * abs(a), (rank, f, t["loss"][f], a)
        for f in ("num_instances", "max_tile_count", "pad_overflow"):
            assert t["diag"][f] == int(getattr(aux, f)), (rank, f)
        for k, mu in new["mu"].items():
            scale = np.abs(mu).max()
            if scale == 0.0:  # the env map's fail value
                assert np.abs(t["mu"][k]).max() == 0.0, k
                continue
            rows = ill if k in LEAVES else None
            assert _within(t["mu"][k], mu, 1e-3, rows, 1.5e-3), (rank, k)
            assert _within(t["nu"][k], new["nu"][k], 2e-3, rows, 3e-3), (rank, k)
            settled = np.abs(mu) > 1e-2 * scale
            dp = np.abs(t["params"][k] - want_p[k])
            assert dp[settled].max(initial=0.0) <= 1e-6 * (1 + np.abs(want_p[k]).max()), (rank, k)
            lr = lrs[param_group(k)]
            assert dp.max() <= 2.5 * lr + 1e-6 * (1 + np.abs(old[k]).max()), (rank, k)
        for f, v in new["stats"].items():
            got = t["stats"][f]
            if f in ("denom", "denom_w", "max_radii"):
                np.testing.assert_array_equal(got, v, err_msg=f)
            else:
                assert _within(got, v, 1e-3, ill, 1.5e-3), f
        assert np.abs(new["stats"]["grad_accum"]).max() > 0


def check_replicas(refs, n, case):
    """The ranks end the step, and the densify event after it, with the
    same bits."""
    first = refs[n]["port"][0][case]
    assert sum(first["densified"]["counts"]) > 0  # the event changed the cloud
    for res in refs[n]["port"][1:]:
        t = res[case]
        assert t["loss"] == first["loss"] and t["diag"] == first["diag"]
        for part in ("params", "mu", "nu", "stats"):
            for k, v in first[part].items():
                np.testing.assert_array_equal(t[part][k], v, err_msg=f"{part}.{k}")
        assert t["densified"]["counts"] == first["densified"]["counts"]
        np.testing.assert_array_equal(t["densified"]["alive"], first["densified"]["alive"])
        for k, v in first["densified"]["params"].items():
            np.testing.assert_array_equal(t["densified"]["params"][k], v, err_msg=k)


@pytest.mark.parametrize("n,case", CASES)
def test_dp_step_matches_jax(refs, n, case):
    check_step(refs, n, case)


@pytest.mark.parametrize("n,case", CASES)
def test_dp_replicas_bit_identical(refs, n, case):
    check_replicas(refs, n, case)
