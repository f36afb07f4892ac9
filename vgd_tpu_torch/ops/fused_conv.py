"""Fused Conv(4x4, stride 2) + train-mode BatchNorm + LeakyReLU
(``vgd_tpu/ops/fused_conv.py``): the encoder (padding 0, slope 0.01; the
VAE-GAN's and the VAE's) and discriminator (padding 1, slope 0.2; the
VAE-GAN's and DCGAN / WGAN's) hot stack as one differentiable op.

* Forward: K1 (``kernels.conv_stats``, CUDA ``csrc/conv_bn_stats.cu``)
  computes the conv with f32 accumulation and the per-channel batch mean
  and biased variance of its output in the same launch; normalise +
  LeakyReLU is one elementwise pass in plain PyTorch (``bn_lrelu``), as the
  JAX package leaves it to XLA.
* Backward (``_cbl_bwd`` of the JAX package, plain PyTorch; there is no
  backward kernel there either): x-hat is recomputed from y (LeakyReLU with
  slope > 0 and the BN affine are invertible; |gamma| is clamped at 1e-3),
  then the train-mode BN backward, and the conv transposes by PyTorch's own
  convolution backward (cuDNN on the card) in ``x.dtype``. The residuals
  are (x, w, gamma, beta, var, y): one output-sized tensor.
* A conv bias cancels under train-mode BN: it only shifts the reported mean
  (the running-stat input), and its gradient is an exact zero tensor, not
  None, so ``torch.optim.Adam`` keeps zero moments for it as optax does.

Under data parallelism (``group``, the mesh's data group) the batch is the
global one, as JAX's sharded-batch jit makes it (``vgd_tpu/models/gan.py``
:18-21, the TPU's SyncBatchNorm): K1 still computes this rank's conv and
statistics in one launch, the ranks' (mean, biased var) are merged by
Chan's formula in rank order (``parallel.collectives.merge_moments``, the
same bits on every rank), and the backward averages the two batch means of
dxhat and dxhat * xhat over the ranks. Both are a few C-sized tensors and
one collective each.

``mean`` and ``var`` are bookkeeping for the running statistics and carry no
gradient. Inside ``kernels.plain_reference()`` the forward takes K1's plain
version (``kernels.conv_stats_plain``) and the backward is the same: the
kernel-free reference differs from the kernel path only in the kernel.
``conv_bn_lrelu_plain`` is the unfused chain, for autograd to check the
backward against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.parallel.collectives import all_mean, merge_moments

_DIMS = (0, 1, 2)


def bn_lrelu(c: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             mean: torch.Tensor, var: torch.Tensor, slope: float,
             eps: float) -> torch.Tensor:
    """LeakyReLU(BN(c)) with the given statistics, in f32."""
    r = torch.rsqrt(var + eps)
    y = (c.float() - mean) * (r * gamma) + beta
    return torch.where(y > 0, y, y * slope)


def conv_bn_lrelu_plain(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        padding: int = 0, slope: float = 0.01,
                        eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unfused reference (the math of ``conv_bn_lrelu_xla``): f32 conv of
    the upcast operands, bias, two-pass batch statistics, ``bn_lrelu``.
    Returns (y, mean, biased var); differentiable by autograd."""
    c = K.conv4x4s2_f32(x, w, padding)
    if bias is not None:
        c = c + bias.float()
    var, mean = torch.var_mean(c, dim=_DIMS, correction=0)
    return bn_lrelu(c, gamma, beta, mean, var, slope, eps), mean, var


class _ConvBnLRelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, gamma, beta, bias, padding, slope, eps, group):
        c, mean, var = K.conv_stats(x, w, padding)
        if group is not None:
            mean, var = merge_moments(mean, var, c.numel() // c.shape[-1],
                                      group)
        y = bn_lrelu(c, gamma, beta, mean, var, slope, eps)
        del c
        ctx.save_for_backward(x, w, gamma, beta, var, y)
        ctx.conf = (padding, slope, eps, group)
        ctx.bias_like = None if bias is None else (bias.shape, bias.dtype,
                                                   bias.device)
        if bias is not None:
            mean = mean + bias.detach().float()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, w, gamma, beta, var, y = ctx.saved_tensors
        padding, slope, eps, group = ctx.conf
        g = gy.float()
        y = y.float()
        pos = y > 0
        g1 = torch.where(pos, g, g * slope)
        # x-hat from y; the 1e-3 floor on |gamma| caps the amplification of
        # rounding in `pre` (see the JAX _cbl_bwd)
        gamma_safe = torch.where(gamma.abs() < 1e-3,
                                 torch.where(gamma < 0, -1e-3, 1e-3), gamma)
        pre = torch.where(pos, y, y / slope)
        xhat = (pre - beta) / gamma_safe
        dgamma = torch.sum(g1 * xhat, dim=_DIMS)
        dbeta = torch.sum(g1, dim=_DIMS)
        # train-mode BN backward (batch statistics in the graph)
        r = torch.rsqrt(var + eps)
        dxhat = g1 * gamma
        m_d = torch.mean(dxhat, dim=_DIMS)
        m_dx = torch.mean(dxhat * xhat, dim=_DIMS)
        if group is not None:        # the global batch's means
            m_d, m_dx = all_mean(torch.stack([m_d, m_dx]), group)
        dc = (dxhat - m_d - xhat * m_dx) * r
        # the conv transposes in the compute dtype, by the stock backward
        cd = x.dtype
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dc.to(cd).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.to(cd),
            None, [2, 2], [padding, padding], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if dx is not None:
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        if dw is not None:
            dw = dw.to(w.dtype)
        dbias = None
        if ctx.bias_like is not None:
            shape, dtype, device = ctx.bias_like
            dbias = torch.zeros(shape, dtype=dtype, device=device)
        return (dx, dw, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dbias,
                None, None, None, None)


def conv_bn_lrelu(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  padding: int = 0, slope: float = 0.01, eps: float = 1e-5,
                  group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Conv4x4s2 + train-BN + LeakyReLU: x (B, H, W, Cin) NHWC in the
    compute dtype, w (K, Cin, 4, 4) in the same dtype, gamma / beta / bias
    (K,) f32. Returns (y f32, batch mean (+ bias), biased batch var). On a
    CUDA tensor the forward runs K1 (or raises); on the CPU its plain
    version. No size gate: odd inputs (the VAE-GAN's 127x127 and the VAE's
    31x31 second encoder layer, which the TPU's space-to-depth gate sends
    to XLA) and the VAE's and DCGAN's small 64x64-model layers run K1 too,
    which measures no slower at each of those shapes than the stock conv +
    statistics (``chip_smoke.py`` prints that decision at each shape every
    run). ``group``: the data-parallel group whose global batch the
    statistics cover (module docstring)."""
    return _ConvBnLRelu.apply(x, w, gamma, beta, bias, padding, slope, eps,
                              group)
