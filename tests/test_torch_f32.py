"""tpu_splat_torch.core.f32 against the JAX package's jitted float32 ops, on
the CPU.

The port's preprocess and model activations round as the JAX package's
jitted CPU code: XLA's float32 `exp` and `log` (Cephes polynomials),
`logistic` as 1 / (1 + exp(-x)), a correctly rounded `sqrt`, and products
contracted into FMAs. On 1e6 inputs an op (numpy seed 0), the count of
results that differ from `jax.jit` of the JAX op is 0 for every helper;
PyTorch's own float32 op on the CPU differs in 210,421 (exp on [-8, 2]),
79,986 (log on [1e-3, 10]), 6,019 (sigmoid on [-8, 2]) and 6,364 (sqrt on
[0, 100]) of them. The counts are printed and asserted 0 and at most
PyTorch's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat_torch.core import f32

N = 1_000_000

OPS = {
    # name: (port, jax, torch, input range)
    "exp": (f32.exp, jnp.exp, torch.exp, (-8.0, 2.0)),
    "exp_wide": (f32.exp, jnp.exp, torch.exp, (-120.0, 100.0)),
    "sigmoid": (f32.sigmoid, jax.nn.sigmoid, torch.sigmoid, (-8.0, 2.0)),
    "sigmoid_wide": (f32.sigmoid, jax.nn.sigmoid, torch.sigmoid, (-120.0, 120.0)),
    "log": (f32.log, jnp.log, torch.log, (1e-3, 10.0)),
    "log_wide": (f32.log, jnp.log, torch.log, (0.0, 3e38)),
    "sqrt": (f32.sqrt, jnp.sqrt, torch.sqrt, (0.0, 100.0)),
}


@pytest.mark.parametrize("name", list(OPS))
def test_op_rounds_as_jitted_jax(name):
    port, jop, top, (lo, hi) = OPS[name]
    x = np.random.default_rng(0).uniform(lo, hi, N).astype(np.float32)
    want = np.asarray(jax.jit(jop)(x))
    t = torch.from_numpy(x)
    n_port = int((port(t).numpy() != want).sum())
    n_torch = int((top(t).numpy() != want).sum())
    print(f"{name}: {n_port} of {N} differ from jax.jit (torch float32: {n_torch})")
    assert n_port <= n_torch
    assert n_port == 0


def test_edges_round_as_jitted_jax():
    e = np.array([0.0, -0.0, 1e-30, 88.0, 88.5, 89.0, 100.0, -87.0, -87.33, -87.34, -100.0,
                  -200.0, np.inf, -np.inf, np.nan], np.float32)
    e = np.concatenate([e, -e])
    for port, jop in ((f32.exp, jnp.exp), (f32.sigmoid, jax.nn.sigmoid)):
        np.testing.assert_array_equal(port(torch.from_numpy(e)).numpy(), np.asarray(jax.jit(jop)(e)))
    pos = np.array([0.0, -1.0, 1e-45, 1e-38, 1.17549435e-38, 1.0, 3.4e38, np.inf, np.nan],
                   np.float32)
    np.testing.assert_array_equal(f32.log(torch.from_numpy(pos)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(pos)))


def test_gradients_are_torchs():
    x = torch.linspace(-6.0, 3.0, 101, requires_grad=True)
    g = torch.autograd.grad((f32.exp(x) * 0.5 + f32.sigmoid(x)).sum(), x)[0]
    xd = x.detach()
    s = torch.sigmoid(xd)
    torch.testing.assert_close(g, torch.exp(xd) * 0.5 + s * (1 - s), rtol=1e-6, atol=0)


def test_fma_sum_is_xlas_reduction_of_a_fused_product():
    rng = np.random.default_rng(1)
    a, b, c = (rng.normal(size=(100_000, 3)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: jnp.sum(a * b * c, axis=-1))(a, b, c))
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    np.testing.assert_array_equal(f32.fma_sum(ta * tb, tc).numpy(), want)
    # a row of a small float32 matrix product is the same chain
    m = rng.normal(size=(3, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, m: a @ m.T)(a, m))
    got = f32.fma_sum(ta[:, None, :], torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fma_gradients_are_the_float32_product_rule():
    rng = np.random.default_rng(2)
    a, b, c = (torch.tensor(rng.normal(size=(50, 4, 3)), dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    m = torch.tensor(rng.normal(size=(3,)), dtype=torch.float32)  # broadcast, no gradient
    g = torch.tensor(rng.normal(size=(50, 4)), dtype=torch.float32)
    got = torch.autograd.grad((f32.fma_sum(a * m, b) * g).sum() + f32.fma(a, b, c).sum(),
                              (a, b, c))
    want = torch.autograd.grad((((a * m) * b).sum(-1) * g).sum() + (a * b + c).sum(), (a, b, c))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_log_and_its_gradient_bit_equal_jax():
    """f32.log forward and backward against jnp.log and jax.grad(jnp.log)
    (and jax.vjp with seeded cotangents) under jax.jit, on 1e5 seeded
    inputs across the float32 range: subnormals, 1e-12, 1, large values.
    Every result bit equal."""
    rng = np.random.default_rng(5)
    n = 100_000
    x = np.concatenate([
        rng.uniform(1e-45, 2.0**-126, 2_000),  # subnormal
        10.0 ** rng.uniform(-38, 38.5, n - 2_010),
        [1e-12, 1.0, 2.0**-126, 3.4e38, 1e-45, 0.5, 2.0, 1e-3, 255.0, 1e-38],
    ]).astype(np.float32)
    assert x.size == n
    ct = rng.normal(size=n).astype(np.float32)
    ct[:50] = rng.uniform(1e-45, 2.0**-126, 50)  # subnormal cotangents
    want = np.asarray(jax.jit(jnp.log)(x))
    want_g = np.asarray(jax.jit(jax.vmap(jax.grad(jnp.log)))(x))
    want_vjp = np.asarray(jax.jit(lambda x, c: jax.vjp(jnp.log, x)[1](c)[0])(x, ct))
    t = torch.from_numpy(x).requires_grad_(True)
    out = f32.log(t)
    np.testing.assert_array_equal(out.detach().numpy().view(np.int32), want.view(np.int32))
    (g,) = torch.autograd.grad(out, t, torch.ones_like(out), retain_graph=True)
    np.testing.assert_array_equal(g.numpy().view(np.int32), want_g.view(np.int32))
    (g,) = torch.autograd.grad(out, t, torch.from_numpy(ct))
    np.testing.assert_array_equal(g.numpy().view(np.int32), want_vjp.view(np.int32))


def test_get_refl_bit_equal_jax():
    from tpu_splat_torch.model.state import GaussianState

    refl = np.random.default_rng(6).uniform(-12, 6, (100_000, 1)).astype(np.float32)
    z = torch.zeros(1)
    st = GaussianState(xyz=z, features_dc=z, features_rest=z, scaling=z, rotation=z,
                       opacity=z, refl=torch.from_numpy(refl), env=None, alive=z)
    want = np.asarray(jax.jit(lambda r: jax.nn.sigmoid(r[:, 0]))(refl))
    np.testing.assert_array_equal(st.get_refl().numpy().view(np.int32), want.view(np.int32))
