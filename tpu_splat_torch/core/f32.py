"""float32 arithmetic that rounds as the JAX package's jitted CPU code does,
with the same bits on the CPU and on the card.

XLA contracts a product into the add that consumes it inside a fusion
(x*y + z becomes fma(x, y, z); a reduction over a fused product is the
chain acc = fma(a_k, b_k, acc) from acc = 0), its sqrt is correctly
rounded, and its float32 `exp` and `log` are the Cephes polynomials below
(`logistic` is 1 / (1 + exp(-x))), with results below the smallest normal
flushed to zero. PyTorch's float32 `exp`, `log`, `sigmoid`, `sqrt` and small
matrix products round in other places, and differently on the CPU and on
the card. Each helper here takes a fused step in float64 and rounds once to
float32: a float32 product is exact in float64, and a float64 add,
multiply, divide or sqrt of float32 values rounded to float32 is the
correctly rounded float32 result, on every device. (A float64 fma rounds
twice; the result can differ from a true fma in about one case in 2^29.)
"""
from __future__ import annotations

import torch

_TINY = 2.0**-126  # smallest normal float32; XLA's CPU code flushes below it


def _fma(x, y, z) -> torch.Tensor:
    # one float64 factor makes the product exact (a float32 tensor operand
    # is widened inside the same op)
    prod = x.double() * y if isinstance(x, torch.Tensor) else y.double() * x
    return (prod + z).float()


def _sum_to(g: torch.Tensor, x) -> torch.Tensor | None:
    """g summed down to the shape of the tensor x (None for a number)."""
    if not isinstance(x, torch.Tensor):
        return None
    return g.sum_to_size(x.shape) if g.shape != x.shape else g


class _Fma(torch.autograd.Function):
    """fma rounded once; its gradient is the float32 product rule."""

    @staticmethod
    def forward(ctx, x, y, z):
        ctx.save_for_backward(*(t for t in (x, y) if isinstance(t, torch.Tensor)))
        ctx.numbers = tuple(None if isinstance(t, torch.Tensor) else t for t in (x, y))
        ctx.z_shape = z.shape if isinstance(z, torch.Tensor) else None
        return _fma(x, y, z)

    @staticmethod
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        x, y = (next(saved) if n is None else n for n in ctx.numbers)
        need = ctx.needs_input_grad
        return (_sum_to(g * y, x) if need[0] else None,
                _sum_to(g * x, y) if need[1] else None,
                g.sum_to_size(ctx.z_shape) if need[2] else None)


class _FmaSum(torch.autograd.Function):
    """The fma chain of a sum of products; its gradient is the float32
    product rule."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        prod = a.double() * b
        acc = (prod[..., 0] + 0.0).float()
        for k in range(1, prod.shape[-1]):
            acc = (prod[..., k] + acc).float()
        return acc

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g[..., None]
        return (_sum_to(g * b, a) if need[0] else None,
                _sum_to(g * a, b) if need[1] else None)


def fma(x, y, z) -> torch.Tensor:
    """float32 x*y + z rounded once (a float32 z joins the float64 sum as
    it is); x, y, z are tensors or numbers that broadcast."""
    return _Fma.apply(x, y, z)


def fma_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] as XLA reduces a fused product (and as
    its CPU dot of a 3-wide row): acc = fma(a_k, b_k, acc) from acc = 0.
    The exact products are formed at once; each step adds one to the
    float32 sum in float64 and rounds."""
    return _FmaSum.apply(a, b)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def _flush(v: torch.Tensor) -> torch.Tensor:
    # to a zero of the same sign, as the CPU's flush-to-zero mode
    return torch.where(v.abs() < _TINY, v * 0.0, v)


_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def _f32c(v: float) -> float:
    """The float32 value of a constant, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32))


_LOG2E, _EXP_C1, _EXP_C2 = (_f32c(v) for v in (_LOG2E, _EXP_C1, _EXP_C2))
_EXP_P = tuple(_f32c(v) for v in _EXP_P)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 exp: e^x = 2^m e^r with m = floor(x log2(e) + 1/2) (at
    most 127), r = x - m ln2 in two steps, e^r a degree-5 polynomial in
    Horner form. Each fused step is float64 ops rounded once (written to
    launch few kernels: a float32 operand widens inside the op)."""
    x = torch.clamp(x.float(), -104.0, 89.0)
    x64 = x.double()
    m = (x64 * _LOG2E).add_(0.5).float().floor_().clamp_(max=127.0)
    m64 = m.double()
    r = torch.add(x64, m64, alpha=-_EXP_C1).float()  # m ln2's products are exact
    r = torch.add(r.double(), m64, alpha=-_EXP_C2).float()
    r64 = r.double()
    y = (r64 * _EXP_P[0]).add_(_EXP_P[1]).float()
    for p in _EXP_P[2:]:
        y = (r64 * y).add_(p).float()
    y = ((r * r).double() * y).add_(r).float() + 1.0  # fma(y, r*r, r) + 1
    # 2^m built from its exponent bits, exact on every device
    two_m = ((m64 + 1023.0).long() << 52).view(torch.float64)
    return _flush((two_m * y).float())


_LOG_P = tuple(_f32c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32c(-2.12194440e-4), _f32c(0.693359375)
_SQRTHF = _f32c(0.707106781186547524)


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log: x = 2^e m with m in [sqrt(1/2), sqrt(2)), log(m)
    by the Cephes degree-8 polynomial in three parts, e ln2 in two steps."""
    x = x.float()
    m, e = torch.frexp(torch.clamp(x, min=_TINY))  # m in [0.5, 1)
    small = m < _SQRTHF
    e = (e - small.int()).float()
    m = (m - 1.0) + torch.where(small, m, 0.0)
    m2 = m * m
    m64, m3 = m.double(), (m2 * m).double()
    y = (m64 * _LOG_P[0]).add_(_LOG_P[1]).float()
    y1 = (m64 * _LOG_P[3]).add_(_LOG_P[4]).float()
    y2 = (m64 * _LOG_P[6]).add_(_LOG_P[7]).float()
    y = (m64 * y).add_(_LOG_P[2]).float()
    y1 = (m64 * y1).add_(_LOG_P[5]).float()
    y2 = (m64 * y2).add_(_LOG_P[8]).float()
    y = (m3 * y).add_(y1).float()
    y = (m3 * y).add_(y2).float()
    y = (m3 * y).add_(e * _LOG_Q1).float()
    out = (e.double() * _LOG_Q2).add_((m - m2 * 0.5) + y).float()
    out = torch.where(x < _TINY, -float("inf"), out)
    return torch.where(x < 0.0, float("nan"), torch.where(x == float("inf"), x, out))


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _exp(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * out


class _Log(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _log(x)

    @staticmethod
    def backward(ctx, g):
        # XLA's VJP of log is one divide, g / x, on operands and a result
        # below the smallest normal flushed to zero
        (x,) = ctx.saved_tensors
        return _flush((_flush(g).double() / _flush(x.float())).float())


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _flush((1.0 + _exp(-x)).double().reciprocal_().float())
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * s * (1.0 - s)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 exp; its gradient is g * exp(x), as for torch.exp."""
    return _Exp.apply(x)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log; its gradient is g / x as XLA divides."""
    return _Log.apply(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as XLA computes it, 1 / (1 + exp(-x)); its gradient is
    g * s * (1 - s)."""
    return _Sigmoid.apply(x)
