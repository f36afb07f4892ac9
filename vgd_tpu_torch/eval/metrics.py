"""Image metrics (``vgd_tpu/eval/metrics.py``): MSE, PSNR, SSIM, the
Frechet distance, the Inception score, manifold precision / recall and the
per-epoch ``MetricAccumulator``.

SSIM, PSNR and MSE run on the device. The feature statistics (FID, IS,
P/R) are host numpy / scipy, as in the JAX package, on features that an
Inception ``feature_fn`` (``eval/inception.load_inception``) made on the
device and ``MetricAccumulator.compute`` reads once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
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


def frechet_distance(feat_real: np.ndarray, feat_fake: np.ndarray) -> float:
    """FID of two feature sets (N, D): ||mu1 - mu2||^2 + Tr(S1 + S2 - 2
    sqrt(S1 S2)), the statistic torchmetrics computes on Inception
    features."""
    from scipy import linalg

    mu1, mu2 = feat_real.mean(0), feat_fake.mean(0)
    s1 = np.cov(feat_real, rowvar=False)
    s2 = np.cov(feat_fake, rowvar=False)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1 @ s2)
    if isinstance(covmean, tuple):   # older scipy returns (sqrtm, errest)
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1 + s2 - 2.0 * covmean))


def inception_score_from_logits(logits: np.ndarray,
                                splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over ``splits`` chunks (the
    torchmetrics default): (mean, std)."""
    logits = np.asarray(logits, np.float64)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(py + 1e-12))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _knn_radii(feat: np.ndarray, k: int, block: int = 2048) -> np.ndarray:
    """Distance from each row to its k-th nearest other row (blocked)."""
    n = feat.shape[0]
    sq = np.sum(feat * feat, axis=1)
    radii = np.empty(n, np.float64)
    for s in range(0, n, block):
        e = min(s + block, n)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (feat[s:e] @ feat.T)
        np.maximum(d2, 0.0, out=d2)
        d2[np.arange(s, e) - s, np.arange(s, e)] = np.inf  # not itself
        radii[s:e] = np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])
    return radii


def _covered_fraction(query: np.ndarray, support: np.ndarray,
                      radii: np.ndarray, block: int = 2048) -> float:
    """Share of the query rows inside any support row's k-NN ball."""
    sq_s = np.sum(support * support, axis=1)
    sq_q = np.sum(query * query, axis=1)
    r2 = radii * radii
    hits = 0
    for s in range(0, query.shape[0], block):
        e = min(s + block, query.shape[0])
        d2 = sq_q[s:e, None] + sq_s[None, :] - 2.0 * (query[s:e] @ support.T)
        np.maximum(d2, 0.0, out=d2)
        hits += int(np.any(d2 <= r2[None, :], axis=1).sum())
    return hits / max(query.shape[0], 1)


def manifold_precision_recall(feat_real: np.ndarray, feat_fake: np.ndarray,
                              k: int = 3) -> Dict[str, float]:
    """Improved precision / recall (Kynkaanniemi et al. 2019): each set's
    manifold is the union of the k-NN balls of its rows. precision: the
    share of fake rows inside the real manifold; recall: of real rows
    inside the fake one; f1 their harmonic mean. NaN with <= k rows."""
    feat_real = np.asarray(feat_real, np.float64)
    feat_fake = np.asarray(feat_fake, np.float64)
    if feat_real.shape[0] <= k or feat_fake.shape[0] <= k:
        return {"precision": float("nan"), "recall": float("nan"),
                "f1": float("nan")}
    rad_real = _knn_radii(feat_real, k)
    rad_fake = _knn_radii(feat_fake, k)
    precision = _covered_fraction(feat_fake, feat_real, rad_real)
    recall = _covered_fraction(feat_real, feat_fake, rad_fake)
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1}


def _to_uint8(unit: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats to uint8 by clip and truncation (the JAX package's
    ``clip(x * 255, 0, 255).astype(uint8)``)."""
    return torch.clamp(unit.float() * 255, 0, 255).to(torch.uint8)


class MetricAccumulator:
    """Per-epoch evaluation over batches: SSIM on [0, 1] images weighted by
    each batch's true rows and, with a ``feature_fn`` (uint8 NHWC ->
    (features, logits), ``eval/inception.load_inception``), FID, IS and
    manifold precision / recall (``manifold_k``; None leaves them out) of
    the fake images' features against the real ones'. Under the
    ``random-init`` weights tag (``weights_tag``, else the feature_fn's)
    the feature keys carry a ``_surrogate`` suffix and IS is left out: a
    random classifier head's IS is about 1 whatever the images. Values and
    features stay on the device until ``compute``, which reads them once."""

    def __init__(self, feature_fn=None, manifold_k: Optional[int] = 3,
                 weights_tag: Optional[str] = None):
        self.feature_fn = feature_fn
        self.manifold_k = manifold_k
        self.weights_tag = (weights_tag if weights_tag is not None
                            else getattr(feature_fn, "weights_tag", None))
        self._ssim_vals: List[Tuple[torch.Tensor, int]] = []
        self._feat_real: List[torch.Tensor] = []
        self._feat_fake: List[torch.Tensor] = []
        self._logits_fake: List[torch.Tensor] = []

    def update(self, fake_unit: torch.Tensor, real_unit: torch.Tensor,
               n_valid: Optional[int] = None) -> None:
        """fake / real in [0, 1], NHWC; only the first ``n_valid`` rows (the
        rest pad a final batch) count."""
        n = fake_unit.shape[0] if n_valid is None else n_valid
        fake_unit, real_unit = fake_unit[:n], real_unit[:n]
        self._ssim_vals.append((ssim(fake_unit, real_unit), n))
        if self.feature_fn is not None:
            f_fake, l_fake = self.feature_fn(_to_uint8(fake_unit))
            f_real, _ = self.feature_fn(_to_uint8(real_unit))
            self._feat_fake.append(f_fake)
            self._feat_real.append(f_real)
            self._logits_fake.append(l_fake)

    def compute(self) -> Dict[str, float]:
        if not self._ssim_vals:
            return {"ssim": 0.0}
        vals = torch.stack([v for v, _ in self._ssim_vals]).double().cpu()
        ns = [n for _, n in self._ssim_vals]
        out = {"ssim": sum(float(v) * n for v, n in zip(vals, ns))
               / max(sum(ns), 1)}
        if self.feature_fn is None or not self._feat_fake:
            return out

        def host(parts):
            return torch.cat(parts).float().cpu().numpy()
        feat_fake, feat_real = host(self._feat_fake), host(self._feat_real)
        surrogate = self.weights_tag == "random-init"
        sfx = "_surrogate" if surrogate else ""
        out["fid" + sfx] = frechet_distance(feat_real, feat_fake)
        if not surrogate:
            is_mean, is_std = inception_score_from_logits(
                host(self._logits_fake))
            out["inception_score"] = is_mean
            out["inception_score_std"] = is_std
        if self.manifold_k is not None:
            pr = manifold_precision_recall(feat_real, feat_fake,
                                           k=self.manifold_k)
            for k in ("precision", "recall", "f1"):
                out[k + sfx] = pr[k]
        return out
