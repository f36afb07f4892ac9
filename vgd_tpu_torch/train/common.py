"""Loss and optimizer primitives (``vgd_tpu/train/common.py``).

``scan_epoch`` has no counterpart: it is a compiled ``lax.scan`` over an
epoch, and the port loops over steps in Python. ``clamp_params`` (WGAN)
comes with the GAN slice.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor,
        reduction: str = "mean") -> torch.Tensor:
    """Squared error in f32, mean or sum over every element."""
    d = torch.square(a.float() - b.float())
    return d.mean() if reduction == "mean" else d.sum()


def bce(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities: ``torch.nn.BCELoss`` itself,
    the reference's loss. Mean over elements, both log terms clamped at
    -100 (the forward of the JAX package's ``bce``). Its backward stays
    finite where the f32 sigmoid saturates to exactly 0 or 1 (a confident
    discriminator at 256x256); the JAX function's gradient is 0/0 there."""
    p = p.float()
    return F.binary_cross_entropy(p, target.to(p.dtype).expand_as(p))


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """``optax.adam`` as a torch optimizer: both keep bias-corrected first
    and second moments and add eps outside the square root, so the update
    is the same (up to f32 rounding order)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)
