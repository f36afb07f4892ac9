"""Image metrics (``vgd_tpu/eval/metrics.py``): MSE, PSNR, SSIM and the
per-epoch ``MetricAccumulator`` (SSIM only: FID, IS and the Inception
features wait for the eval slice)."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


def mse_metric(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    return torch.mean(torch.square(pred.float() - target.float()))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, per-image MSE, mean over the batch."""
    p = pred.float().reshape(pred.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    per_img_mse = torch.mean(torch.square(p - t), dim=1)
    return torch.mean(10.0 * torch.log10(
        data_range ** 2 / torch.clamp(per_img_mse, min=1e-12)))


SSIM_WINDOW, SSIM_SIGMA, SSIM_K1, SSIM_K2 = 11, 1.5, 0.01, 0.03


def _gaussian_kernel(device) -> torch.Tensor:
    coords = torch.arange(SSIM_WINDOW, dtype=torch.float32, device=device) \
        - (SSIM_WINDOW - 1) / 2.0
    g = torch.exp(-torch.square(coords) / (2 * SSIM_SIGMA * SSIM_SIGMA))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Structural similarity of NHWC images, mean over the batch
    (torchmetrics semantics with data_range (0, 1), as the JAX package):
    inputs clamped into the range, Gaussian 11x11 window with sigma 1.5,
    VALID windows, f32, self-variances clamped at 0, mean over every
    window and channel. On the card the convolutions run in full f32 (TF32
    is off, ``core.rng.resolve_device``): E[x^2] - E[x]^2 needs it."""
    pred = torch.clamp(pred.float(), 0.0, data_range)
    target = torch.clamp(target.float(), 0.0, data_range)
    c = pred.shape[-1]
    weight = _gaussian_kernel(pred.device)[None, None].expand(
        c, 1, SSIM_WINDOW, SSIM_WINDOW)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c)

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_pp = torch.clamp(filt(pred * pred) - mu_pp, min=0.0)
    sigma_tt = torch.clamp(filt(target * target) - mu_tt, min=0.0)
    sigma_pt = filt(pred * target) - mu_pt
    c1 = (SSIM_K1 * data_range) ** 2
    c2 = (SSIM_K2 * data_range) ** 2
    ssim_map = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / \
        ((mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2))
    return torch.mean(ssim_map)


class MetricAccumulator:
    """Per-epoch evaluation over batches: SSIM on [0, 1] images, weighted
    by each batch's true rows. Values stay on the device until
    ``compute``, which reads them once. A ``feature_fn`` (FID / IS
    features) is not ported yet and raises."""

    def __init__(self, feature_fn=None):
        if feature_fn is not None:
            raise NotImplementedError(
                "FID / IS feature extraction is not ported yet")
        self._ssim_vals: List[Tuple[torch.Tensor, int]] = []

    def update(self, fake_unit: torch.Tensor, real_unit: torch.Tensor,
               n_valid: Optional[int] = None) -> None:
        """fake / real in [0, 1], NHWC; only the first ``n_valid`` rows (the
        rest pad a final batch) count."""
        n = fake_unit.shape[0] if n_valid is None else n_valid
        self._ssim_vals.append((ssim(fake_unit[:n], real_unit[:n]), n))

    def compute(self) -> Dict[str, float]:
        if not self._ssim_vals:
            return {"ssim": 0.0}
        vals = torch.stack([v for v, _ in self._ssim_vals]).double().cpu()
        ns = [n for _, n in self._ssim_vals]
        return {"ssim": sum(float(v) * n for v, n in zip(vals, ns))
                / max(sum(ns), 1)}
