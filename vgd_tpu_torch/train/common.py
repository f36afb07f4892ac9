"""Loss and optimizer primitives (``vgd_tpu/train/common.py``).

``scan_epoch`` has no counterpart: it is a compiled ``lax.scan`` over an
epoch, and the port loops over steps in Python. ``bce`` and
``clamp_params`` come with the VAE-GAN slice.
"""
from __future__ import annotations

from typing import Iterable

import torch


def mse(a: torch.Tensor, b: torch.Tensor,
        reduction: str = "mean") -> torch.Tensor:
    """Squared error in f32, mean or sum over every element."""
    d = torch.square(a.float() - b.float())
    return d.mean() if reduction == "mean" else d.sum()


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """``optax.adam`` as a torch optimizer: both keep bias-corrected first
    and second moments and add eps outside the square root, so the update
    is the same (up to f32 rounding order)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)
