"""Image dtype/range conversions (``vgd_tpu/ops/image.py``)."""
from __future__ import annotations

import torch


def to_unit(x_uint8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 -> [0, 1] (ToTensor)."""
    return x_uint8.to(dtype) / 255.0


def to_signed(x_uint8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 -> [-1, 1] (ToTensor + Normalize(0.5, 0.5))."""
    return x_uint8.to(dtype) / 127.5 - 1.0


def signed_to_unit(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) * 0.5


def unit_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8 with clamping."""
    return torch.clamp(x * 255.0, 0, 255).to(torch.uint8)
