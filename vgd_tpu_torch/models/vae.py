"""Convolutional VAE encoder and the latent helpers
(``vgd_tpu/models/vae.py``).

Four Conv 4x4 stride-2 VALID layers with bias, each followed by BatchNorm
and LeakyReLU(0.01), channels (32, 64, 128, 256); the NHWC map is flattened
and two f32 Dense heads give (mu, logvar). Activations stay NHWC, so the
flatten order is the JAX package's and the Dense kernels carry over
without a permutation. The Flax module sizes its Dense input lazily; here
it follows from ``img_size``.

``fused=True`` with ``train=True`` runs each conv layer through
``ops.fused_conv.conv_bn_lrelu`` (K1 on the card), as the JAX Encoder does
with ``fused``; the parameters and running stats are the same either way.
Kernels keep Flax's defaults (``lecun_normal`` and zero biases; BN scale 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vgd_tpu_torch.models.blocks import BatchNorm
from vgd_tpu_torch.models.unet import Dense
from vgd_tpu_torch.ops.conv import Conv
from vgd_tpu_torch.ops.fused_conv import conv_bn_lrelu

F32 = torch.float32
CHANNELS = (32, 64, 128, 256)


def _valid_out(size: int) -> int:
    return (size - 4) // 2 + 1


class Encoder(nn.Module):
    """x (B, H, W, C) in [-1, 1] -> (mu, logvar), each (B, latent) f32."""

    def __init__(self, img_size: int, in_ch: int = 3, latent_dim: int = 100,
                 dtype: torch.dtype = F32, fused: bool = False):
        super().__init__()
        self.n_layers, self.dtype, self.fused = len(CHANNELS), dtype, fused
        prev, size = in_ch, img_size
        for i, ch in enumerate(CHANNELS):
            setattr(self, f"conv{i}", Conv(prev, ch, 4, stride=2, padding=0,
                                           bias=True, dtype=dtype))
            setattr(self, f"bn{i}", BatchNorm(ch))
            prev, size = ch, _valid_out(size)
        flat = size * size * prev
        self.fc_mu = Dense(flat, latent_dim, F32)
        self.fc_logvar = Dense(flat, latent_dim, F32)

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax-default init: lecun_normal kernels, zero biases, BN scale 1
        and zero shift, running stats (0, 1)."""
        with torch.no_grad():
            for i in range(self.n_layers):
                conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
                conv.reset_parameters(generator)
                bn.weight.fill_(1.0)
                bn.bias.zero_()
                bn.running_mean.zero_()
                bn.running_var.fill_(1.0)
            for fc in (self.fc_mu, self.fc_logvar):
                fc.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        h = x.to(dt)
        for i in range(self.n_layers):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            if self.fused and train:
                y, m, v = conv_bn_lrelu(h.contiguous(), conv.weight.to(dt),
                                        bn.weight, bn.bias, bias=conv.bias,
                                        padding=0, slope=0.01, eps=bn.eps,
                                        group=bn.group)
                bn.update(m, v)
                h = y.to(dt)
                continue
            h = F.leaky_relu(bn(conv(h), train), 0.01).to(dt)
        h = h.reshape(h.shape[0], -1).float()
        return self.fc_mu(h), self.fc_logvar(h)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor,
                   clamp: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """z = mu + exp(0.5 * clamp(logvar, -10, 10)) * eps, with the standard
    normal draw ``eps`` from the caller (no clamp with ``clamp=False``, as
    the latent traversal takes it). Returns (z, the logvar used)."""
    if clamp:
        logvar = torch.clamp(logvar, -10.0, 10.0)
    std = torch.exp(0.5 * logvar)
    return mu + std * eps.to(std.dtype), logvar


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor,
                  mean_over_batch: bool = True) -> torch.Tensor:
    """KL(q || N(0, I)) = -0.5 * sum(1 + logvar - mu^2 - exp(logvar)), over
    the batch size when ``mean_over_batch`` (the VAE-GAN trainer)."""
    kl = -0.5 * torch.sum(1.0 + logvar - torch.square(mu) - torch.exp(logvar))
    return kl / mu.shape[0] if mean_over_batch else kl


def latent_to_spatial(z: torch.Tensor) -> torch.Tensor:
    """(B, latent) -> (B, 1, 1, latent), the decoder's NHWC input."""
    return z[:, None, None, :]
