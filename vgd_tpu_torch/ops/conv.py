"""Convolution layers on NHWC activations (``vgd_tpu/ops/conv.py`` and the
Flax ``nn.Conv`` the VAE-GAN networks use).

Activations stay NHWC, as in the JAX package: a convolution sees the NCHW
permutation of an NHWC tensor, which is PyTorch's channels_last layout, so
no copy is made. Both layers compute in ``dtype`` (bf16 by default in the
trainers) from f32 parameters, as the Flax modules do.

Weight layouts, for the weight bridge: ``Conv.weight`` is (out, in, kh,
kw), the HWIO kernel transposed (3, 2, 0, 1); ``ConvTranspose.weight`` is
torch's ``ConvTranspose2d`` layout (in, out, kh, kw), which is the JAX
package's *unflipped* HWIO kernel transposed (2, 3, 0, 1): its
``conv_transpose2d`` applies the spatial flip itself, exactly as torch's
transposed convolution does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vgd_tpu_torch.ops.initializers import lecun_normal_


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Flax ``nn.Conv`` with a square kernel, a stride and symmetric integer
    padding, on NHWC input."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Flax's defaults: ``lecun_normal`` kernel, zero bias."""
        _, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, None if self.bias is None
                          else self.bias.to(self.dtype))

    def unbiased(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without its bias, for a caller that adds
        ``self.bias`` itself (the fused UNet's K4 adds it as it reads the
        output, rounding as ``forward``'s add does)."""
        return self._conv(x, None)

    def _conv(self, x, b):
        dt = self.dtype
        return nhwc(F.conv2d(nchw(x).to(dt), self.weight.to(dt), b,
                             stride=self.stride, padding=self.padding))


class ConvTranspose(nn.Module):
    """torch ``ConvTranspose2d(k, stride, padding)`` without bias, on NHWC
    input (``vgd_tpu/ops/conv.py`` ``ConvTranspose``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 4, stride: int = 2,
                 padding: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return nhwc(F.conv_transpose2d(nchw(x).to(dt), self.weight.to(dt),
                                       stride=self.stride,
                                       padding=self.padding))
