"""Aggregated-posterior sampling of the VAE (``vgd_tpu/eval/sampling.py``),
the port's own numpy copy: encode the dataset, build per-dimension
empirical CDFs of (mu, logvar), inverse-transform sample. On the same
numpy inputs and ``default_rng`` seed it gives the JAX package's arrays
bit for bit. Prior sampling, Glow's reverse and the DDPM chain live with
their trainers.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def vals_to_hist(arr: np.ndarray, n_bins: int = 100
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dimension histogram CDFs. arr: (N, D). Returns (bins (D,
    n_bins+1), cdf (D, n_bins))."""
    n, d = arr.shape
    out_cdf = np.zeros((d, n_bins))
    out_bins = np.zeros((d, n_bins + 1))
    for i in range(d):
        freqs, bins = np.histogram(arr[:, i], bins=n_bins)
        out_cdf[i] = np.cumsum(freqs / n)
        out_bins[i] = bins
    return out_bins, out_cdf


def sample_distribution(bins: np.ndarray, cdf: np.ndarray,
                        n_samples: int = 1,
                        rng: np.random.Generator = None) -> np.ndarray:
    """Inverse-transform sampling from per-dimension empirical CDFs: a bin
    by its CDF, then uniform within the bin. (n_samples, D) f32."""
    rng = rng or np.random.default_rng()
    d, n_bins = cdf.shape
    u = rng.random((n_samples, d))
    idx = np.empty((n_samples, d), np.int64)
    for i in range(d):
        idx[:, i] = np.searchsorted(cdf[i], u[:, i])
    idx = np.clip(idx, 0, n_bins - 1)
    x0 = np.take_along_axis(bins[None, :, :-1], idx[:, :, None],
                            axis=2)[:, :, 0]
    x1 = np.take_along_axis(bins[None, :, 1:], idx[:, :, None],
                            axis=2)[:, :, 0]
    return (x0 + rng.random((n_samples, d)) * (x1 - x0)).astype(np.float32)


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def encode_dataset(encode_fn: Callable, loaders, max_batches: int = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every batch of the given loaders (``epoch()`` yields (uint8
    batch, true rows)) with ``encode_fn(batch) -> (mu, logvar)`` (arrays
    or tensors) -> stacked (mu, logvar) over the true rows."""
    all_mu, all_logvar = [], []
    for loader in loaders:
        for i, (batch, n_valid) in enumerate(loader.epoch()):
            if max_batches is not None and i >= max_batches:
                break
            mu, logvar = encode_fn(batch)
            all_mu.append(_numpy(mu)[:n_valid])
            all_logvar.append(_numpy(logvar)[:n_valid])
    return np.concatenate(all_mu), np.concatenate(all_logvar)


def aggregated_posterior_sampler(encode_fn: Callable, loaders,
                                 n_bins: int = 100, seed: int = 42,
                                 max_batches: int = None):
    """sample(n) -> (mu, logvar) arrays drawn from the aggregated
    posterior's per-dimension CDFs, over at most ``max_batches`` batches of
    each loader."""
    mu, logvar = encode_dataset(encode_fn, loaders, max_batches)
    mu_bins, mu_cdf = vals_to_hist(mu, n_bins)
    lv_bins, lv_cdf = vals_to_hist(logvar, n_bins)
    rng = np.random.default_rng(seed)

    def sample(n: int):
        return (sample_distribution(mu_bins, mu_cdf, n, rng),
                sample_distribution(lv_bins, lv_cdf, n, rng))

    return sample
