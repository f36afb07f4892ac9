"""Run artifacts (``vgd_tpu/io/artifacts.py``): the metric log, sample
grids and noisy / clean / reconstruction panels.

Grids and panels are written as ``.npy`` arrays of the images in [-1, 1]:
the JAX package draws them with matplotlib, which the port does not depend
on. Loss-curve plots and image files wait for the IO slice.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


class MetricLog:
    """Append-only metric history: one JSON line per row in
    ``<out_dir>/<name>.jsonl`` as rows arrive, and the whole table as
    ``<name>.npz`` (``values`` rows x ``columns``) on ``save``."""

    def __init__(self, out_dir: str, name: str = "loss"):
        self.out_dir = out_dir
        self.name = name
        self.history: List[Dict[str, float]] = []
        os.makedirs(out_dir, exist_ok=True)

    def append(self, **metrics: float) -> None:
        row = {k: float(v) for k, v in metrics.items()}
        self.history.append(row)
        with open(os.path.join(self.out_dir, f"{self.name}.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def save(self) -> None:
        if not self.history:
            return
        keys = sorted({k for row in self.history for k in row})
        arr = np.full((len(self.history), len(keys)), np.nan)
        for i, row in enumerate(self.history):
            for j, k in enumerate(keys):
                if k in row:
                    arr[i, j] = row[k]
        np.savez(os.path.join(self.out_dir, f"{self.name}.npz"),
                 values=arr, columns=np.array(keys))

    def curves(self) -> Dict[str, List[float]]:
        keys = sorted({k for row in self.history for k in row})
        return {k: [row.get(k, float("nan")) for row in self.history]
                for k in keys}


def _npy(images) -> np.ndarray:
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    return np.asarray(images, np.float32)


def _save(path: str, arr: np.ndarray) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, arr)
    return path


def save_grid(images, path: str) -> str:
    """The first 64 images (N, H, W, C) in [-1, 1] (the JAX package's 8 x 8
    grid) as an (n, H, W, C) ``.npy`` at ``path``."""
    return _save(path, _npy(images)[:64])


def save_triplets(noisy, clean, recon, path: str) -> str:
    """The first 6 noisy / clean / reconstructed images as a
    (3, n, H, W, C) ``.npy`` at ``path``."""
    return _save(path, np.stack([_npy(x)[:6] for x in (noisy, clean, recon)]))
