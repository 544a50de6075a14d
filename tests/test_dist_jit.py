"""Compiled twins of the four eager shard_map tests of tests/test_dist.py.

Those four run render(mesh=...), or jax.grad of it, outside jax.jit, so each
compiles one 8-device program per primitive; the top-level conftest.py marks
them slow. Each twin here builds the same scene and holds the 8-way render to
the single-device one with the same assertions and tolerances, with both sides
compiled through jax.jit.
"""
import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp

from tpu_splat.dist import make_mesh
from tpu_splat.raster.config import RasterConfig
from tpu_splat.renderer import render
from tests.test_dist import CFG, H, W, _setup

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jit_render(state, cam, cfg, bg, mesh=None):
    return jax.jit(
        lambda s: render(s, cam, cfg, bg, initial_stage=False, mesh=mesh)
    )(state)


def test_sharded_render_matches_single():
    state, cam = _setup()
    mesh = make_mesh(8)
    bg = jnp.array([0.2, 0.1, 0.3])
    out1 = _jit_render(state, cam, CFG, bg)
    out8 = _jit_render(state, cam, CFG, bg, mesh=mesh)
    assert out1.render.shape[:2] == (H, W)
    np.testing.assert_allclose(out8.render, out1.render, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out8.alpha, out1.alpha, atol=1e-5)
    np.testing.assert_allclose(out8.normal, out1.normal, atol=1e-4)
    np.testing.assert_allclose(
        out8.gaussian_weights, out1.gaussian_weights, atol=1e-6
    )


def test_sharded_gradients_match_single():
    state, cam = _setup(n=40, capacity=64)
    mesh = make_mesh(8)
    bg = jnp.zeros(3)

    def make_loss(mesh):
        def loss(params):
            s = state.with_params(params)
            o = render(s, cam, CFG, bg, initial_stage=False, mesh=mesh)
            return jnp.mean((o.render - 0.3) ** 2) + 0.1 * jnp.mean(o.dist)

        return loss

    p = state.param_pytree()
    g1 = jax.jit(jax.grad(make_loss(None)))(p)
    g8 = jax.jit(jax.grad(make_loss(mesh)))(p)
    for k in g1:
        a, b = np.asarray(g1[k]), np.asarray(g8[k])
        assert not np.any(np.isnan(b)), k
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-4, err_msg=k)


def test_sharded_pallas_matches_single():
    """Pallas kernel pair under 8-way tile sharding == single-device."""
    state, cam = _setup(n=50, capacity=64)
    mesh = make_mesh(8)
    pal = RasterConfig(
        max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256,
        chunk=16, backend="pallas",
    )
    bg = jnp.array([0.2, 0.1, 0.3])
    o1 = _jit_render(state, cam, pal, bg)
    o8 = _jit_render(state, cam, pal, bg, mesh=mesh)
    np.testing.assert_allclose(o8.render, o1.render, atol=1e-5)
    np.testing.assert_allclose(o8.gaussian_weights, o1.gaussian_weights, atol=1e-6)

    def loss(params, mesh):
        s = state.with_params(params)
        o = render(s, cam, pal, bg, initial_stage=False, mesh=mesh)
        return jnp.mean((o.render - 0.3) ** 2)

    p = state.param_pytree()
    g1 = jax.jit(jax.grad(lambda q: loss(q, None)))(p)
    g8 = jax.jit(jax.grad(lambda q: loss(q, mesh)))(p)
    for k in g1:
        a, b = np.asarray(g1[k]), np.asarray(g8[k])
        assert not np.any(np.isnan(b)), k
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-3, err_msg=k)


def test_sharded_binning_production_switches():
    """The fully-sharded tile-slab pipeline (binning+pack+blend per chip,
    raster/sharded.py) under the PRODUCTION switch set (train-shaped grads,
    bf16 regroup + content rows) matches single-device to bf16 tolerance,
    and per-Gaussian gradient psum is exact across the 8-way mesh."""
    from tpu_splat.raster.config import production_config

    state, cam = _setup(n=50, capacity=64)
    mesh = make_mesh(8)
    prod = production_config(
        max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256,
        chunk=16, backend="pallas",
    )
    bg = jnp.zeros(3)
    o1 = _jit_render(state, cam, prod, bg)
    o8 = _jit_render(state, cam, prod, bg, mesh=mesh)
    # bf16 content rows: forward content channels carry ~2^-9 rounding but
    # the INSTANCE SETS must agree, so the images agree to bf16 tolerance
    np.testing.assert_allclose(o8.render, o1.render, atol=5e-3)
    np.testing.assert_allclose(o8.alpha, o1.alpha, atol=1e-5)
    np.testing.assert_allclose(
        o8.gaussian_weights, o1.gaussian_weights, atol=1e-5
    )

    def loss(params, mesh):
        s = state.with_params(params)
        o = render(s, cam, prod, bg, initial_stage=False, mesh=mesh)
        return jnp.mean((o.render - 0.3) ** 2)

    p = state.param_pytree()
    g1 = jax.jit(jax.grad(lambda q: loss(q, None)))(p)
    g8 = jax.jit(jax.grad(lambda q: loss(q, mesh)))(p)
    for k in g1:
        a, b = np.asarray(g1[k]), np.asarray(g8[k])
        assert not np.any(np.isnan(b)), k
        scale = np.abs(a).max() + 1e-8
        # per-shard bf16 rounding differs from single-device rounding only
        # through which instances share a packed pair — tolerance covers it
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-3, err_msg=k)


def _assigned_tuple(path, name):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{name} not assigned in {path}")


def test_slow_node_ids_name_eager_tests_with_twins():
    """Every id the top-level conftest marks slow names a function of
    tests/test_dist.py (read with ast), and has a twin here: a
    renamed test fails this check instead of quietly running eagerly again."""
    ids = _assigned_tuple(REPO / "conftest.py", "SLOW_NODE_IDS")
    assert len(ids) == 4
    dist = REPO / "tests" / "test_dist.py"
    defined = {
        n.name
        for n in ast.parse(dist.read_text()).body
        if isinstance(n, ast.FunctionDef)
    }
    for node_id in ids:
        path, name = node_id.split("::")
        assert path == "tests/test_dist.py", node_id
        assert name in defined, f"{node_id} names no function in {dist}"
        assert callable(globals().get(name)), f"{name} has no twin here"
