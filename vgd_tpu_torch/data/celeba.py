"""Image datasets (``vgd_tpu/data/celeba.py``): a folder of JPEGs decoded
once into a uint8 memmap cache, or synthetic faces.

``_decode_one`` and ``_decode_folder`` are the JAX package's decode: PIL
resizes the short side (bilinear) and crops the centre, uint8; the decode
runs on a thread pool (PIL releases the GIL in the JPEG decoder and the
resampler) and the memmap is flushed in chunks. The cache is the same
``.npy`` file under the same name (``.vgd_cache_{h}x{w}_{tag}.npy``, in the
folder, or ``~/.cache/vgd_tpu_data`` when the folder is read-only), so
either package opens the other's. A ``path`` that is not a folder falls
back to synthetic faces, as in the JAX package; ``make_image_datasets``
prints one ``[data]`` line naming the source. ``synthetic_faces`` is the
same numpy code as the JAX package's, so both packages see the same bytes
from a seed. Batches are uint8 host arrays gathered by the native gather
(``data/native.py``), as the JAX package's are; the consumer moves them to
its device. PIL is imported where a JPEG is decoded, only.
"""
from __future__ import annotations

import concurrent.futures
import glob
import hashlib
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from vgd_tpu_torch.core.config import DataConfig
from vgd_tpu_torch.data import native


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


def _decode_one(p: str, h: int, w: int) -> np.ndarray:
    """One JPEG: resize so the short side matches (bilinear), then crop the
    centre, uint8 (h, w, 3)."""
    from PIL import Image

    img = Image.open(p).convert("RGB")
    iw, ih = img.size
    scale = max(h / ih, w / iw)
    nw, nh = max(int(round(iw * scale)), w), max(int(round(ih * scale)), h)
    img = img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - w) // 2, (nh - h) // 2
    img = img.crop((left, top, left + w, top + h))
    return np.asarray(img, dtype=np.uint8)


def cache_path(path: str, image_size: Tuple[int, int], count: int) -> str:
    """The memmap cache of ``count`` images of ``path`` at ``image_size``
    (the JAX package's name)."""
    h, w = image_size
    tag = hashlib.md5(f"{path}|{h}x{w}|{count}".encode()).hexdigest()[:12]
    cache_dir = path if os.access(path, os.W_OK) else os.path.expanduser(
        "~/.cache/vgd_tpu_data")
    return os.path.join(cache_dir, f".vgd_cache_{h}x{w}_{tag}.npy")


def _decode_folder(path: str, image_size: Tuple[int, int],
                   dataset_size: Optional[int],
                   workers: Optional[int] = None,
                   progress: bool = True) -> np.ndarray:
    """The sorted ``*.jpg`` of ``path`` (the first ``dataset_size``) as a
    uint8 (N, h, w, 3) memmap: the cache when it exists, else decoded into
    ``<cache>.tmp`` chunk by chunk on ``workers`` threads and renamed."""
    paths = sorted(glob.glob(os.path.join(path, "*.jpg")))
    if not paths:
        raise FileNotFoundError(f"no *.jpg under {path}")
    if dataset_size is not None:
        paths = paths[:dataset_size]
    h, w = image_size
    cache = cache_path(path, image_size, len(paths))
    if os.path.exists(cache):
        return np.load(cache, mmap_mode="r")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    out = np.lib.format.open_memmap(cache + ".tmp", mode="w+",
                                    dtype=np.uint8,
                                    shape=(len(paths), h, w, 3))
    workers = workers or min(32, (os.cpu_count() or 1) * 4)
    chunk = 2048
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        for c0 in range(0, len(paths), chunk):
            c1 = min(c0 + chunk, len(paths))
            for i, arr in zip(range(c0, c1),
                              ex.map(_decode_one, paths[c0:c1],
                                     [h] * (c1 - c0), [w] * (c1 - c0))):
                out[i] = arr
            out.flush()
            if progress and len(paths) > chunk:
                rate = c1 / max(time.perf_counter() - t0, 1e-9)
                print(f"[data] decode cache {c1}/{len(paths)} "
                      f"({rate:.0f} img/s, {workers} threads)")
    del out
    os.replace(cache + ".tmp", cache)
    return np.load(cache, mmap_mode="r")


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
    batch; the eval loader pads it by repeating its last row. Each batch is
    gathered by the native gather (``data/native.py``, on threads sized to
    the batch's bytes) at the sorted indices of its step (sorted: a faster
    memmap read); ``selections`` and ``stream_selections`` give those
    indices, so that a consumer can gather straight into its own buffer
    (the training loop's pinned staging, ``utils/prefetch.py``)."""

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

    def _order(self) -> np.ndarray:
        """This pass's order of the indices; the pass counter advances."""
        idx = self.indices
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self._epoch
                                        ).permutation(idx)
        self._epoch += 1
        return idx

    def stream_selections(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        """The sorted indices of ``stream(start_batch)``'s batches."""
        b = self.batch_size
        per = max(len(self.indices) // b, 1)
        self._epoch = start_batch // per
        skip = start_batch % per
        while True:
            idx = self._order()
            for i in range(skip, len(idx) // b):
                yield np.sort(idx[i * b:(i + 1) * b])
            skip = 0

    def stream(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        """Endless full batches from global batch index ``start_batch``: a
        resumed run sees exactly the batches a straight run would (the
        skipped prefix replays only the shuffle permutations, never the
        gathers)."""
        for sel in self.stream_selections(start_batch):
            yield self._gather(sel)

    def selections(self) -> Iterator[Tuple[np.ndarray, int]]:
        """``(sorted indices, n_valid)`` of ``epoch()``'s batches: a padded
        final batch repeats its last index."""
        idx = self._order()
        b = self.batch_size
        n_full = len(idx) // b
        for i in range(n_full):
            yield np.sort(idx[i * b:(i + 1) * b]), b
        rem = len(idx) - n_full * b
        if rem and not self.drop_last:
            sel = np.sort(idx[n_full * b:])
            yield np.concatenate([sel, np.repeat(sel[-1:], b - rem)]), rem

    def epoch(self) -> Iterator[Tuple[np.ndarray, int]]:
        for sel, n in self.selections():
            yield self._gather(sel), n

    def _gather(self, sel: np.ndarray) -> np.ndarray:
        """The batch of ``sel``, on threads sized to its bytes."""
        return native.gather_batch(self.ds.array, sel,
                                   n_threads=native.threads_for(
                                       sel.size * int(np.prod(
                                           self.ds.image_shape))))


def make_image_datasets(cfg: DataConfig, seed: int = 42):
    """(train_loader, val_loader, image_shape HWC) over the JPEG folder
    ``cfg.path`` (decoded once into its memmap cache), or over synthetic
    faces when ``cfg.path`` is unset or not a folder."""
    if cfg.path and os.path.isdir(cfg.path):
        t0 = time.perf_counter()
        arr = _decode_folder(cfg.path, cfg.image_size, cfg.dataset_size)
        cache = cache_path(cfg.path, cfg.image_size, len(arr))
        print(f"[data] {len(arr)} images {arr.shape[1]}x{arr.shape[2]} from "
              f"{cfg.path} (cache {cache}, {time.perf_counter() - t0:.2f} s)")
    else:
        n = cfg.dataset_size or 512
        arr = synthetic_faces(n, cfg.image_size, cfg.channels, seed=seed)
        print(f"[data] {n} synthetic faces {cfg.image_size[0]}x"
              f"{cfg.image_size[1]} (seed {seed})" + (
                  f": {cfg.path} is not a folder" if cfg.path else ""))
    ds = ArrayDataset(arr)
    tr_idx, va_idx = split_dataset(ds, cfg.train_fraction, seed)
    train = Loader(ds, tr_idx, cfg.batch_size, shuffle=True, seed=seed)
    val = Loader(ds, va_idx, cfg.batch_size, shuffle=False, seed=seed,
                 drop_last=False)
    return train, val, ds.image_shape
