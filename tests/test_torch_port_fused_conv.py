"""The port's fused Conv4x4s2 + train-BN + LeakyReLU (``ops/fused_conv.py``,
K1's plain path on the CPU) against the JAX package in f32.

Numpy makes the inputs; the JAX side is ``conv_bn_lrelu`` with the Pallas
kernel in interpret mode for even shapes (as ``tests/test_fused_conv.py``
runs it) and ``conv_bn_lrelu_xla`` for an odd input, which the TPU path
gates away from the kernel. Tolerances are the JAX test's: forward rtol
1e-4 / atol 1e-5, gradients rtol 2e-4 / atol 2e-5 (f32 both sides,
summed in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.ops import fused_conv as JF
from vgd_tpu_torch.ops import fused_conv as PF
from vgd_tpu_torch.ops import kernels as K

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _inputs(b=4, h=16, c=6, k=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 4, c, k))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(k)).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, k).astype(np.float32)
    return x, w, gamma, beta, bias


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())


def _port(x, w, gamma, beta, bias=None, padding=0, slope=0.01):
    args = [torch.from_numpy(x).requires_grad_(), _oihw(w).requires_grad_(),
            torch.from_numpy(gamma).requires_grad_(),
            torch.from_numpy(beta).requires_grad_()]
    b = None if bias is None else torch.from_numpy(bias).requires_grad_()
    y, m, v = PF.conv_bn_lrelu(*args, bias=b, padding=padding, slope=slope)
    return (y, m, v), args, b


@pytest.mark.parametrize("padding,slope", [(0, 0.01), (1, 0.2)])
def test_forward_matches_pallas_interpret(padding, slope):
    """Even input (16x16): against the Pallas kernel in interpret mode, and
    the plain K1 statistics against the kernel's (c, mean, var)."""
    x, w, gamma, beta, _ = _inputs()
    want = JF.conv_bn_lrelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma),
                            jnp.asarray(beta), padding=padding, slope=slope,
                            force="pallas", interpret=True)
    (y, m, v), _, _ = _port(x, w, gamma, beta, padding=padding, slope=slope)
    for got, ref in zip((y, m, v), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   **FWD)
    c, mean, var = JF._conv_stats_pallas(jnp.asarray(x), jnp.asarray(w),
                                         padding, True)
    before = K.LAUNCHES["conv_bn_stats"]
    pc, pm, pv = K.conv_stats(torch.from_numpy(x), _oihw(w), padding)
    assert K.LAUNCHES["conv_bn_stats"] == before       # CPU: plain version
    np.testing.assert_allclose(pc.numpy(), np.asarray(c), **FWD)
    np.testing.assert_allclose(pm.numpy(), np.asarray(mean), **FWD)
    np.testing.assert_allclose(pv.numpy(), np.asarray(var), **FWD)


@pytest.mark.parametrize("padding,slope", [(0, 0.01), (1, 0.2)])
def test_odd_input_matches_xla(padding, slope):
    """A 31x31 input (the TPU path sends odd sizes to XLA; the port has no
    gate), with a conv bias: it only shifts the reported mean."""
    x, w, gamma, beta, bias = _inputs(b=3, h=31, c=5, k=7, seed=1)
    want = JF.conv_bn_lrelu_xla(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(gamma), jnp.asarray(beta),
                                bias=jnp.asarray(bias), padding=padding,
                                slope=slope)
    (y, m, v), _, _ = _port(x, w, gamma, beta, bias, padding, slope)
    for got, ref in zip((y, m, v), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   **FWD)
    y0 = _port(x, w, gamma, beta, None, padding, slope)[0][0]
    np.testing.assert_allclose(y.detach().numpy(), y0.detach().numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("padding,slope,h", [(0, 0.01, 16), (1, 0.2, 16),
                                             (0, 0.01, 31)])
def test_backward_matches_jax_custom_vjp(padding, slope, h):
    """Gradients of x, w, gamma and beta against the JAX custom VJP (the
    Pallas forward in interpret mode where the shape is even), for a random
    cotangent of y."""
    x, w, gamma, beta, bias = _inputs(h=h, seed=2)
    ho = (h + 2 * padding - 4) // 2 + 1
    cot = np.random.default_rng(3).standard_normal(
        (x.shape[0], ho, ho, w.shape[-1])).astype(np.float32)
    force = "pallas" if h % 2 == 0 else "xla"

    def f(xx, ww, gg, bb):
        y, _, _ = JF.conv_bn_lrelu(xx, ww, gg, bb, bias=jnp.asarray(bias),
                                   padding=padding, slope=slope, force=force,
                                   interpret=True)
        return jnp.sum(y * cot)
    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w, gamma, beta)))
    (y, _, _), (px, pw, pg, pb), pbias = _port(x, w, gamma, beta, bias,
                                               padding, slope)
    y.backward(torch.from_numpy(cot))
    got = (px.grad, pw.grad.permute(2, 3, 1, 0), pg.grad, pb.grad)
    for name, g, ref in zip("x w gamma beta".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **GRAD,
                                   err_msg=name)
    # the conv bias gets an exact zero tensor (Adam then keeps its moments)
    assert pbias.grad is not None and torch.equal(
        pbias.grad, torch.zeros_like(pbias.grad))


def test_custom_backward_matches_autograd_of_the_unfused_chain():
    """The custom backward against autograd through ``conv_bn_lrelu_plain``
    (no |gamma| clamp is reached at these scales); inside plain_reference()
    the op keeps its custom backward and gives the same values."""
    x, w, gamma, beta, bias = _inputs(h=12, seed=4)
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 5, 5, 12)).astype(np.float32))
    grads = []
    for how in ("fused", "plain_reference", "unfused"):
        args = [torch.from_numpy(x).requires_grad_(), _oihw(w).requires_grad_(),
                torch.from_numpy(gamma).requires_grad_(),
                torch.from_numpy(beta).requires_grad_()]
        if how == "unfused":
            y, _, _ = PF.conv_bn_lrelu_plain(*args, bias=torch.from_numpy(bias))
            assert "ConvBnLRelu" not in type(y.grad_fn).__name__
        elif how == "plain_reference":
            with K.plain_reference():
                y, _, _ = PF.conv_bn_lrelu(*args, bias=torch.from_numpy(bias))
            assert "ConvBnLRelu" in type(y.grad_fn).__name__
        else:
            y, _, _ = PF.conv_bn_lrelu(*args, bias=torch.from_numpy(bias))
        y.backward(cot)
        grads.append([a.grad.clone() for a in args])
    for a, r in zip(grads[0], grads[1]):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    for a, r in zip(grads[0], grads[2]):
        torch.testing.assert_close(a, r, **GRAD)


def test_gamma_clamp_in_backward():
    """|gamma| below 1e-3 is floored at 1e-3 (sign kept) when x-hat is
    recomputed, exactly as the JAX backward does."""
    x, w, gamma, beta, _ = _inputs(h=10, seed=6)
    gamma[:3] = np.array([0.0, 5e-4, -2e-4], np.float32)
    cot = np.random.default_rng(7).standard_normal((4, 4, 4, 12)).astype(
        np.float32)

    def f(gg):
        y, _, _ = JF.conv_bn_lrelu(jnp.asarray(x), jnp.asarray(w), gg,
                                   jnp.asarray(beta), force="xla")
        return jnp.sum(y * cot)
    want = jax.grad(f)(jnp.asarray(gamma))
    (y, _, _), (_, _, pg, _), _ = _port(x, w, gamma, beta)
    y.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(pg.grad.numpy(), np.asarray(want), **GRAD)
