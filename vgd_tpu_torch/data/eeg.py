"""EEG trials (BCI Competition IV 2a) for the 1-D Glow
(``vgd_tpu/data/eeg.py``, numpy + scipy, the port's own copy).

* ``.npz`` recordings with keys ``s`` (signal), ``etyp`` (event types) and
  ``epos`` (event positions); the first 22 channels at fs = 250 Hz;
* trials: motor-imagery cues {769, 770, 771, 772, 783} or the baseline cue
  768, 640-sample windows decimated x4 to (22, 160); truncated or
  non-finite windows are skipped;
* per-subject file filter and T (training) / E (evaluation) sessions.

Without a data folder a synthetic generator makes band-limited trials with
a class-dependent mu rhythm (8-13 Hz) on the central channels, so the TSTR
evaluation runs end to end. It makes the same numpy calls in the same order
as the JAX package's, so its trials are bit-equal to those.
"""
from __future__ import annotations

import glob as _glob
import os
import zlib
from typing import Iterator, List, Optional

import numpy as np
from scipy.signal import decimate

FS = 250
MI_CUES = (769, 770, 771, 772, 783)
BASELINE_CUE = 768
WINDOW = 640
DOWNSAMPLING = 4
NUM_CHANNELS = 22

CHANNEL_NAMES = [
    "Fz", "FC3", "FC1", "FCz", "FC2", "FC4",
    "C5", "C3", "C1", "Cz", "C2", "C4", "C6",
    "CP3", "CP1", "CPz", "CP2", "CP4",
    "P1", "Pz", "P2", "POz",
]


def extract_trials(data, event_type: str = "mi",
                   downsampling: int = DOWNSAMPLING) -> List[np.ndarray]:
    """Decimated (22, 160) trials of one recording, in event order."""
    signal = np.asarray(data["s"]).T[:NUM_CHANNELS]
    etyp = np.asarray(data["etyp"]).T
    epos = np.asarray(data["epos"]).T
    if event_type == "mi":
        idxs = [i for i, e in enumerate(etyp[0]) if e in MI_CUES]
    else:
        idxs = [i for i, e in enumerate(etyp[0]) if e == BASELINE_CUE]
    trials = []
    for idx in idxs:
        start = int(epos[0, idx])
        stop = start + WINDOW
        if stop > signal.shape[1]:
            continue
        trial = signal[:, start:stop]
        if not np.all(np.isfinite(trial)):
            continue
        trials.append(decimate(trial, downsampling))
    return trials


#: Per-trial lognormal sigma of the central channels' mu amplitude: the
#: classes overlap, so CSP + LDA on the synthetic trials lands between
#: chance and 1.0 (about 0.83 accuracy) instead of separating them by
#: construction.
OVERLAP_SIGMA = 0.7


def synthetic_trials(n: int, event_type: str, seed: int = 0,
                     num_channels: int = NUM_CHANNELS,
                     num_samples: int = WINDOW // DOWNSAMPLING,
                     erd: float = 0.25,
                     overlap: float = OVERLAP_SIGMA) -> np.ndarray:
    """(n, C, T) float32: integrated white noise, normalised per channel,
    plus a mu rhythm per channel, stronger on C3 / Cz / C4 and scaled there
    by one lognormal gain per trial; motor-imagery trials multiply it by
    ``erd`` (event-related desynchronisation). ``overlap`` 0 gives fully
    separable classes."""
    rng = np.random.default_rng(seed + (0 if event_type == "mi" else 10_000))
    fs = FS / DOWNSAMPLING
    t = np.arange(num_samples) / fs
    out = np.empty((n, num_channels, num_samples), np.float32)
    central = {7, 9, 11}  # C3, Cz, C4
    for i in range(n):
        x = rng.normal(0, 1.0, (num_channels, num_samples)).astype(np.float32)
        x = np.cumsum(x, axis=1)
        x -= x.mean(axis=1, keepdims=True)
        x /= (x.std(axis=1, keepdims=True) + 1e-6)
        # one gain a trial, shared by the central channels (independent
        # draws per channel would average out under CSP)
        gain = float(rng.lognormal(0.0, overlap)) if overlap > 0 else 1.0
        for ch in range(num_channels):
            f_mu = rng.uniform(9.0, 12.0)
            phase = rng.uniform(0, 2 * np.pi)
            amp = 1.5 if ch in central else 0.4
            if ch in central:
                amp *= gain
                if event_type == "mi":
                    amp *= erd
            x[ch] += amp * np.sin(2 * np.pi * f_mu * t + phase)
        out[i] = x * 10.0
    return out


class EEGDataset:
    """Trials as float32 (N, C, T); ``as_nhwc`` gives the 1-D Glow's
    (N, T, 1, C) layout, time as height."""

    def __init__(self, path: Optional[str] = None, dataset_type: str = "T",
                 event_type: str = "mi", subject: Optional[str] = None,
                 synthetic_n: int = 288, seed: int = 42):
        trials: List[np.ndarray] = []
        if path:
            pattern = os.path.join(path, f"*{dataset_type}.npz")
            files = sorted(_glob.glob(pattern))
            if subject:
                files = [f for f in files if subject in os.path.basename(f)]
            for f in files:
                trials.extend(extract_trials(np.load(f), event_type))
        if trials:
            self.dataset = np.asarray(trials, dtype=np.float32)
        else:
            # a salt that every process computes alike (hash() is salted
            # per process), so the training and evaluation processes see
            # the same synthetic T / E sessions
            salt = zlib.crc32(f"{dataset_type}|{subject or ''}".encode()) \
                & 0xFFFF
            self.dataset = synthetic_trials(synthetic_n, event_type,
                                            seed=seed + salt)

    def __len__(self) -> int:
        return len(self.dataset)

    def as_ncT(self) -> np.ndarray:
        """(N, C, T) float32, for the host-side analysis (CSP, LDA, PSD)."""
        return self.dataset

    def as_nhwc(self) -> np.ndarray:
        """(N, T, 1, C) float32."""
        return np.ascontiguousarray(
            self.dataset.transpose(0, 2, 1)[:, :, None, :])


def eeg_batches(ds: EEGDataset, batch_size: int, seed: int = 42,
                skip: int = 0) -> Iterator[np.ndarray]:
    """Endless shuffled stream of (B, T, 1, C) batches, the last partial
    batch of each pass dropped. ``skip`` passes over the first ``skip``
    batches (resume): their permutations are drawn, so the stream continues
    where an uninterrupted run would be, but they are not gathered."""
    arr = ds.as_nhwc()
    n = len(arr)
    per = max(n // batch_size, 1)
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        start, skip = min(skip, per), max(skip - per, 0)
        for i in range(start, n // batch_size):
            yield arr[perm[i * batch_size:(i + 1) * batch_size]]
