"""Weight initialisers (``vgd_tpu/ops/initializers.py``), in place, each
drawing from an explicit ``torch.Generator``.

The reference's DCGAN init (``weights_init``): conv weights ~ N(0, 0.02),
BatchNorm scale ~ N(1, 0.02) and bias 0. ``lecun_normal_`` is Flax's
default kernel init, which the Encoder, the Dense layers and the UNet keep.
The two packages draw different numbers from one seed; the tests carry the
weights over the bridge instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def dcgan_conv_init(w: torch.Tensor,
                    generator: Optional[torch.Generator]) -> None:
    """w ~ N(0, 0.02)."""
    nn.init.normal_(w, 0.0, 0.02, generator=generator)


def dcgan_bn_scale_init(w: torch.Tensor,
                        generator: Optional[torch.Generator]) -> None:
    """w ~ N(1, 0.02)."""
    nn.init.normal_(w, 1.0, 0.02, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """Flax's default kernel init: variance_scaling(1, fan_in,
    truncated_normal), i.e. a normal truncated at two standard deviations
    and rescaled so the truncated distribution has variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
