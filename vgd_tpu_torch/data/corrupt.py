"""Image corruption of the denoising VAE (``vgd_tpu/data/corrupt.py``):
gaussian noise with a per-sample random std, and an occlusion rectangle of
uniform noise, on the device over the whole batch.

The JAX functions draw from a key; PyTorch cannot reproduce those draws, so
each function here is a pure function of its draws (``CorruptDraws``), and
``corrupt_draws`` makes them from an explicit ``torch.Generator``:

* rectangle sides ``rect_h`` / ``rect_w`` (B,) int, uniform in [lo, hi] with
  lo = max(round(min(H, W) * RECT_MIN_SIZE), 1), hi = round(min(H, W) *
  RECT_MAX_SIZE);
* ``u_x`` / ``u_y`` (B,) uniform [0, 1): the top-left corner is
  round(W * 0.25) + int(u_x * max(round(W * 0.75) + 1 - rect_w - round(W *
  0.25), 1)) (and so for y), so the rectangle stays in the central band;
* ``fill`` (B, H, W, C) uniform [0, 1), mapped to [-1, 1] inside it;
* ``std_u`` (B,) uniform [0, 1), the per-sample std over ``noise_max_std``;
* ``noise`` (B, H, W, C) standard normal.

Images are NHWC in [-1, 1]. The order is the reference's: the rectangle
first, then the noise, then the clamp.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


# the rectangle's sides, as fractions of min(H, W) (the reference's defaults)
RECT_MIN_SIZE, RECT_MAX_SIZE = 0.01, 0.25


class CorruptDraws(NamedTuple):
    """The draws of one ``corrupt`` call."""
    std_u: torch.Tensor
    noise: torch.Tensor
    rect_h: torch.Tensor
    rect_w: torch.Tensor
    u_x: torch.Tensor
    u_y: torch.Tensor
    fill: torch.Tensor


def rect_side_range(h: int, w: int) -> Tuple[int, int]:
    """(lo, hi), the inclusive range of the rectangle's sides."""
    s = min(h, w)
    return (max(int(round(s * RECT_MIN_SIZE)), 1),
            int(round(s * RECT_MAX_SIZE)))


def add_gaussian_noise(img: torch.Tensor, noise_max_std: float,
                       std_u: torch.Tensor, noise: torch.Tensor
                       ) -> torch.Tensor:
    """img + noise * (std_u * noise_max_std), one std per sample, clamped
    to [-1, 1]."""
    std = std_u.to(img.dtype).reshape((-1,) + (1,) * (img.ndim - 1)) \
        * noise_max_std
    return torch.clamp(img + noise.to(img.dtype) * std, -1.0, 1.0)


def add_occlusion_rectangle(img: torch.Tensor, rect_h: torch.Tensor,
                            rect_w: torch.Tensor, u_x: torch.Tensor,
                            u_y: torch.Tensor, fill: torch.Tensor
                            ) -> torch.Tensor:
    """Each sample's rectangle (module docstring) filled with
    ``fill * 2 - 1``."""
    b, h, w, _ = img.shape
    dev = img.device
    rect_h, rect_w = rect_h.to(dev, torch.int32), rect_w.to(dev, torch.int32)
    x0_lo, y0_lo = int(round(w * 0.25)), int(round(h * 0.25))
    x_hi = int(round(w * 0.75)) + 1 - rect_w          # exclusive upper bound
    y_hi = int(round(h * 0.75)) + 1 - rect_h
    # f32 product, truncated to int32, as the JAX function computes it
    x0 = x0_lo + (u_x.to(dev, torch.float32)
                  * torch.clamp(x_hi - x0_lo, min=1)).to(torch.int32)
    y0 = y0_lo + (u_y.to(dev, torch.float32)
                  * torch.clamp(y_hi - y0_lo, min=1)).to(torch.int32)
    ys = torch.arange(h, device=dev, dtype=torch.int32)[None, :, None, None]
    xs = torch.arange(w, device=dev, dtype=torch.int32)[None, None, :, None]

    def col(t):
        return t[:, None, None, None]
    mask = ((ys >= col(y0)) & (ys < col(y0 + rect_h))
            & (xs >= col(x0)) & (xs < col(x0 + rect_w)))
    return torch.where(mask, fill.to(img.dtype) * 2.0 - 1.0, img)


def corrupt(img: torch.Tensor, noise_max_std: float,
            draws: CorruptDraws) -> torch.Tensor:
    """The reference pipeline: the rectangle, then per-sample-std noise,
    then the clamp."""
    out = add_occlusion_rectangle(img, draws.rect_h, draws.rect_w,
                                  draws.u_x, draws.u_y, draws.fill)
    return add_gaussian_noise(out, noise_max_std, draws.std_u, draws.noise)


def corrupt_draws(shape, generator: Optional[torch.Generator],
                  device) -> CorruptDraws:
    """The draws of ``corrupt`` for images of ``shape`` (B, H, W, C), on
    ``device`` from ``generator``: the rectangle's (sides, then positions,
    then fill), then the noise's (std, then the normal draw)."""
    b, h, w, _ = shape
    lo, hi = rect_side_range(h, w)

    def sides():
        return torch.randint(lo, hi + 1, (b,), generator=generator,
                             device=device, dtype=torch.int32)
    rect_h, rect_w = sides(), sides()
    u_x = torch.rand((b,), generator=generator, device=device)
    u_y = torch.rand((b,), generator=generator, device=device)
    fill = torch.rand(shape, generator=generator, device=device)
    std_u = torch.rand((b,), generator=generator, device=device)
    noise = torch.randn(shape, generator=generator, device=device)
    return CorruptDraws(std_u=std_u, noise=noise, rect_h=rect_h,
                        rect_w=rect_w, u_x=u_x, u_y=u_y, fill=fill)
