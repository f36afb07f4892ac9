"""DCGAN generator and discriminator, also the VAE-GAN decoder
(``vgd_tpu/models/gan.py``).

* Generator: ConvTranspose(4x4, stride 1, valid) from z (B, 1, 1, nz) to a
  4x4 map of ngf*16 channels, then stride-2 ConvTranspose(4, 2, 1) stages
  doubling the size and halving the channels, each with BatchNorm + ReLU,
  closed by a 3x3 conv and an f32 tanh.
* Discriminator: stride-2 Conv(4, 2, 1) stages doubling the channels from
  ndf/4, BatchNorm on every stage but the first, LeakyReLU(0.2), a 4x4
  valid conv to one logit and an f32 sigmoid. With ``fused`` and
  ``train`` the stages i > 0 run ``ops.fused_conv.conv_bn_lrelu`` (K1 on
  the card); the first stage has no BatchNorm and is never fused.
  ``return_features`` also returns the last stage's activation (the
  "Dis_l" feature loss).

Depth follows ``img_size`` (4 * 2^n). Conv weights ~ N(0, 0.02) and BN
scales ~ N(1, 0.02) (the reference's DCGAN init). NHWC throughout; convs
compute in ``dtype`` from f32 parameters, BatchNorm in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vgd_tpu_torch.models.blocks import BatchNorm
from vgd_tpu_torch.ops.conv import Conv, ConvTranspose
from vgd_tpu_torch.ops.fused_conv import conv_bn_lrelu
from vgd_tpu_torch.ops.initializers import dcgan_bn_scale_init, dcgan_conv_init

F32 = torch.float32


def _num_stages(img_size: int) -> int:
    n, s = 0, img_size
    while s > 4:
        if s % 2:
            raise ValueError(f"img_size must be 4*2^n, got {img_size}")
        s //= 2
        n += 1
    return n


def _dcgan_init(module: nn.Module, generator: Optional[torch.Generator]
                ) -> None:
    """N(0, 0.02) conv weights, N(1, 0.02) BN scales, zero BN shifts,
    running stats (0, 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                dcgan_conv_init(m.weight, generator)
            elif isinstance(m, BatchNorm):
                dcgan_bn_scale_init(m.weight, generator)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


class Generator(nn.Module):
    """z (B, 1, 1, nz) -> image (B, H, W, nc) in [-1, 1]."""

    def __init__(self, img_size: int = 256, nz: int = 128, ngf: int = 64,
                 nc: int = 3, dtype: torch.dtype = F32):
        super().__init__()
        self.n_up = _num_stages(img_size)
        self.dtype = dtype
        ch0 = ngf * 16
        self.up0 = ConvTranspose(nz, ch0, 4, stride=1, padding=0, dtype=dtype)
        self.bn0 = BatchNorm(ch0)
        prev = ch0
        for i in range(1, self.n_up + 1):
            ch = max(ch0 >> i, nc)
            setattr(self, f"up{i}", ConvTranspose(prev, ch, 4, stride=2,
                                                  padding=1, dtype=dtype))
            setattr(self, f"bn{i}", BatchNorm(ch))
            prev = ch
        self.out = Conv(prev, nc, 3, padding=1, bias=False, dtype=dtype)

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        _dcgan_init(self, generator)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = z.to(self.dtype)
        for i in range(self.n_up + 1):
            x = getattr(self, f"up{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x, train)).to(self.dtype)
        return torch.tanh(self.out(x).float())


class Discriminator(nn.Module):
    """image (B, H, W, nc) -> score (B,) f32 (and the features)."""

    def __init__(self, img_size: int = 256, ndf: int = 64, nc: int = 3,
                 dtype: torch.dtype = F32, fused: bool = False):
        super().__init__()
        self.n_down = _num_stages(img_size)
        self.dtype, self.fused = dtype, fused
        prev = nc
        for i in range(self.n_down):
            ch = (ndf // 4) << i
            setattr(self, f"down{i}", Conv(prev, ch, 4, stride=2, padding=1,
                                           bias=False, dtype=dtype))
            if i > 0:
                setattr(self, f"bn{i}", BatchNorm(ch))
            prev = ch
        self.out = Conv(prev, 1, 4, padding=0, bias=False, dtype=dtype)

    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        _dcgan_init(self, generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                return_features: bool = False):
        dt = self.dtype
        h = x.to(dt)
        for i in range(self.n_down):
            conv = getattr(self, f"down{i}")
            if self.fused and train and i > 0:
                bn = getattr(self, f"bn{i}")
                y, m, v = conv_bn_lrelu(h.contiguous(), conv.weight.to(dt),
                                        bn.weight, bn.bias, padding=1,
                                        slope=0.2, eps=bn.eps,
                                        group=bn.group)
                bn.update(m, v)
                h = y.to(dt)
                continue
            h = conv(h)
            if i > 0:
                h = getattr(self, f"bn{i}")(h, train)
            h = F.leaky_relu(h.float(), 0.2).to(dt)
        feat = h
        score = torch.sigmoid(self.out(h).reshape(h.shape[0]).float())
        if return_features:
            return score, feat.float()
        return score
