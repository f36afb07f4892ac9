"""Run artifacts (``vgd_tpu/io/artifacts.py``): the metric log, sample
grids, noisy / clean / reconstruction panels and loss curves.

Grids and panels are written twice: as ``.npy`` arrays of the images in
[-1, 1], and as an image file beside them (8 images a row; panels one row
each of noisy, clean, reconstruction) with PIL where it imports; the JAX
package draws them with matplotlib. Loss curves are drawn with matplotlib
where it imports (``utils.viz.have_matplotlib``), as the JAX package draws
them; without it the ``.npz`` / ``.jsonl`` of ``MetricLog`` hold the same
numbers.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vgd_tpu_torch.utils.viz import have_matplotlib


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


def _paths(path: str) -> Tuple[str, str]:
    """(the ``.npy`` path, the image path) for ``path``: an image path
    ``<stem>.jpg`` / ``.png`` keeps its name with ``<stem>.npy`` beside it;
    any other path is the array's, with ``<stem>.png`` beside it."""
    stem, ext = os.path.splitext(path)
    if ext.lower() in (".jpg", ".jpeg", ".png"):
        return stem + ".npy", path
    return (path if ext == ".npy" else path + ".npy"), stem + ".png"


def _tile(rows: Sequence[np.ndarray]) -> np.ndarray:
    """Rows of (n, H, W, C) images in [-1, 1] -> one uint8 (rows H, n W,
    C) picture (short rows padded black)."""
    n = max(len(r) for r in rows)
    _, h, w, c = rows[0].shape
    out = np.zeros((len(rows) * h, n * w, c), np.uint8)
    for i, row in enumerate(rows):
        row = np.clip(np.round((row + 1.0) * 127.5), 0, 255).astype(np.uint8)
        for j, img in enumerate(row):
            out[i * h:(i + 1) * h, j * w:(j + 1) * w] = img
    return out


def _write(arr: np.ndarray, npy_path: str, image_path: str,
           picture: Optional[np.ndarray]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(npy_path)), exist_ok=True)
    np.save(npy_path, arr)
    if picture is not None and importlib.util.find_spec("PIL") is not None:
        from PIL import Image
        Image.fromarray(picture[..., 0] if picture.shape[-1] == 1
                        else picture).save(image_path)
    return npy_path


def save_grid(images, path: str) -> str:
    """The first 64 images (N, H, W, C) in [-1, 1] (the JAX package's 8 x 8
    grid) as an (n, H, W, C) ``.npy`` and, where PIL imports, as a grid
    picture of 8 images a row (``_paths``: which of the two ``path``
    names). Returns the ``.npy`` path."""
    arr = _npy(images)[:64]
    npy_path, image_path = _paths(path)
    rows = [arr[i:i + 8] for i in range(0, len(arr), 8)]
    return _write(arr, npy_path, image_path,
                  _tile(rows) if arr.ndim == 4 and len(arr) else None)


def save_triplets(noisy, clean, recon, path: str) -> str:
    """The first 6 noisy / clean / reconstructed images as a (3, n, H, W,
    C) ``.npy`` and, where PIL imports, a picture of three rows. Returns
    the ``.npy`` path."""
    arr = np.stack([_npy(x)[:6] for x in (noisy, clean, recon)])
    npy_path, image_path = _paths(path)
    return _write(arr, npy_path, image_path, _tile(list(arr)))


def save_loss_curves(curves: Dict[str, Sequence[float]], path: str
                     ) -> Optional[str]:
    """Named loss curves over epochs (or iterations), drawn with matplotlib
    (Agg) where it imports; returns the path, or None without matplotlib."""
    if not have_matplotlib() or not curves:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 5))
    for name, values in curves.items():
        plt.plot(values, label=name)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.grid(True)
    plt.legend()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=90)
    plt.close(fig)
    return path


def epoch_metrics(log: MetricLog, prefix: str = "") -> None:
    """The loss curves as ``<out_dir>/<prefix>losses.jpg`` and the log's
    ``.npz``: what the JAX loops write after each epoch
    (``_epoch_metrics_header``)."""
    save_loss_curves(log.curves(), os.path.join(log.out_dir,
                                                f"{prefix}losses.jpg"))
    log.save()
