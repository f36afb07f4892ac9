"""Image datasets (``vgd_tpu/data/celeba.py``), synthetic source only.

``synthetic_faces`` is the same numpy code as the JAX package's, so both
packages see the same bytes from a seed. Folder-of-JPEG decoding needs PIL
and waits for the data slice: a ``path`` raises ``NotImplementedError``.
Batches are uint8 host arrays; the consumer moves them to its device.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from vgd_tpu_torch.core.config import DataConfig


class ArrayDataset:
    """A uint8 (N, H, W, C) array-backed dataset."""

    def __init__(self, array: np.ndarray):
        if array.dtype != np.uint8 or array.ndim != 4:
            raise ValueError(f"expected uint8 (N, H, W, C), got "
                             f"{array.dtype} {array.shape}")
        self.array = array

    def __len__(self) -> int:
        return self.array.shape[0]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.array.shape[1:])

    def __getitem__(self, idx):
        return self.array[idx]


def synthetic_faces(n: int, image_size: Tuple[int, int], channels: int = 3,
                    seed: int = 0) -> np.ndarray:
    """Deterministic procedural images (smooth colour blobs + an oval).
    uint8 (N, H, W, C)."""
    h, w = image_size
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ys, xs = ys / h - 0.5, xs / w - 0.5
    out = np.empty((n, h, w, channels), dtype=np.uint8)
    for i in range(n):
        cy, cx = rng.uniform(-0.15, 0.15, 2)
        ry, rx = rng.uniform(0.2, 0.35, 2)
        oval = np.exp(-(((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2) * 2.5)
        img = np.empty((h, w, channels), np.float32)
        for c in range(channels):
            fy, fx = rng.uniform(1.0, 4.0, 2)
            py, px = rng.uniform(0, 2 * np.pi, 2)
            base = 0.5 + 0.25 * np.sin(2 * np.pi * fy * ys + py) * \
                np.cos(2 * np.pi * fx * xs + px)
            tone = rng.uniform(0.3, 0.9)
            img[..., c] = base * (1 - oval) + tone * oval
        out[i] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return out


def split_dataset(ds: ArrayDataset, train_fraction: float, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Random train/val index split."""
    n = len(ds)
    n_train = int(round(train_fraction * n))
    perm = np.random.default_rng(seed).permutation(n)
    return perm[:n_train], perm[n_train:]


class Loader:
    """Minibatch iterator over an ArrayDataset subset, yielding
    ``(uint8 batch, n_valid)``. The train loader drops the last partial
    batch; the eval loader pads it by repeating its last row."""

    def __init__(self, ds: ArrayDataset, indices: np.ndarray, batch_size: int,
                 shuffle: bool, seed: int = 0, drop_last: bool = True):
        self.ds = ds
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_examples(self) -> int:
        return len(self.indices)

    def set_epoch(self, epoch: int) -> None:
        """Make the next ``epoch()`` pass the ``epoch``-th one (its shuffle
        order), so a resumed run sees the batches a straight run would."""
        self._epoch = int(epoch)

    def epoch(self) -> Iterator[Tuple[np.ndarray, int]]:
        idx = self.indices
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self._epoch).permutation(idx)
        self._epoch += 1
        b = self.batch_size
        n_full = len(idx) // b
        for i in range(n_full):
            yield self.ds.array[np.sort(idx[i * b:(i + 1) * b])], b
        rem = len(idx) - n_full * b
        if rem and not self.drop_last:
            batch = self.ds.array[np.sort(idx[n_full * b:])]
            pad = np.repeat(batch[-1:], b - rem, axis=0)
            yield np.concatenate([batch, pad], 0), rem


def make_image_datasets(cfg: DataConfig, seed: int = 42):
    """(train_loader, val_loader, image_shape HWC) over synthetic faces."""
    if cfg.path:
        raise NotImplementedError(
            "image folders are not ported yet; leave DataConfig.path unset "
            "for the synthetic dataset")
    n = cfg.dataset_size or 512
    ds = ArrayDataset(synthetic_faces(n, cfg.image_size, cfg.channels,
                                      seed=seed))
    tr_idx, va_idx = split_dataset(ds, cfg.train_fraction, seed)
    train = Loader(ds, tr_idx, cfg.batch_size, shuffle=True, seed=seed)
    val = Loader(ds, va_idx, cfg.batch_size, shuffle=False, seed=seed,
                 drop_last=False)
    return train, val, ds.image_shape
