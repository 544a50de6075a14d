"""The seamless filter's face padding (`envmap/cubemap.py:_pad_faces`): its
cached device tables, against the JAX package's `_pad_faces`.

The padded texture equals the JAX one bit for bit; its texture gradient is
within 1e-6 of the largest |grad| of JAX's VJP (the corner slots divide by
3 as JAX's does, the sums run in another order) and the same bits on every
run. The tables are built once per (L, device).

The `gpu` test imports no JAX, so on a machine with a CUDA card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_cubemap_pad.py
"""
import numpy as np
import pytest
import torch

from tests.torch_threads import one_thread  # noqa: F401
from tpu_splat_torch.envmap import cubemap as cm

LS = (2, 3, 8, 64, 128)


def _texture(L, seed=0):
    rng = np.random.default_rng(seed + L)
    return rng.uniform(-1, 1, (6, 3, L, L)).astype(np.float32)


@pytest.mark.parametrize("L", LS)
def test_pad_faces_matches_jax_bit_for_bit(L):
    import jax.numpy as jnp
    from tpu_splat.envmap.cubemap import _pad_faces as jax_pad_faces

    tex = _texture(L)
    want = np.asarray(jax_pad_faces(jnp.asarray(tex)))
    got = cm._pad_faces(torch.from_numpy(tex))
    assert got.shape == (6, 3, L + 2, L + 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", LS)
def test_pad_faces_grad_matches_jax_vjp(L):
    import jax
    import jax.numpy as jnp
    from tpu_splat.envmap.cubemap import _pad_faces as jax_pad_faces

    tex = _texture(L)
    g = np.random.default_rng(100 + L).normal(size=(6, 3, L + 2, L + 2)).astype(np.float32)
    _, vjp = jax.vjp(jax_pad_faces, jnp.asarray(tex))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(tex).requires_grad_(True)
    got = torch.autograd.grad(torch.sum(cm._pad_faces(t) * torch.from_numpy(g)), t)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("L", LS)
def test_pad_faces_grad_is_deterministic(L):
    t = torch.from_numpy(_texture(L)).requires_grad_(True)
    g = torch.from_numpy(
        np.random.default_rng(200 + L).normal(size=(6, 3, L + 2, L + 2)).astype(np.float32))
    a, b = (torch.autograd.grad(torch.sum(cm._pad_faces(t) * g), t)[0] for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("L", (3, 64))
def test_pad_tables_built_once_per_resolution(L, monkeypatch):
    monkeypatch.setattr(cm, "_PAD_TABLES", {})
    params = cm.init_cubemap(torch.Generator().manual_seed(L), 3, L, device="cpu")
    dirs = torch.randn(17, 3, generator=torch.Generator().manual_seed(1))
    n0 = cm.pad_table_builds()
    cm.sample_cubemap(params, dirs)
    assert cm.pad_table_builds() == n0 + 1
    for _ in range(2):
        cm.sample_cubemap(params, dirs)
    assert cm.pad_table_builds() == n0 + 1
    doubled = cm.resize_cubemap(params, 2 * L)
    cm.sample_cubemap(doubled, dirs)
    assert cm.pad_table_builds() == n0 + 2
    cm.sample_cubemap(doubled, dirs)
    cm.sample_cubemap(params, dirs)
    assert cm.pad_table_builds() == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("grad", (True, False))
def test_sample_cubemap_makes_no_host_sync(grad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    params = cm.init_cubemap(torch.Generator().manual_seed(3), 3, 128, device=dev)
    tex = params.texture.clone().requires_grad_(grad)
    params = cm.CubemapParams(tex, params.fail_value)
    dirs = torch.randn(1088, 1920, 3, device=dev)
    with torch.set_grad_enabled(grad):
        cm.sample_cubemap(params, dirs)  # warm-up: builds the tables
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = cm.sample_cubemap(params, dirs)
            if grad:  # the padding's backward too
                torch.autograd.grad(torch.sum(cm._pad_faces(tex)), tex)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (1088, 1920, 3)
    assert torch.isfinite(out).all()
