"""Figures of the EEG workflow (``vgd_tpu/utils/viz.py``): stacked trace
plots and the training-evolution GIF. matplotlib and PIL are imported
inside the functions, so the port imports and trains without them;
``have_matplotlib`` lets a caller decide up front whether it can draw."""
from __future__ import annotations

import importlib.util
from typing import Sequence

import numpy as np


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def save_gif(frame_paths: Sequence[str], out_path: str,
             duration_ms: int = 750) -> None:
    """Assemble image frames into a looping GIF (PIL)."""
    from PIL import Image

    frames = [Image.open(p).convert("P") for p in frame_paths]
    if not frames:
        return
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)


def plot_eeg_signals(trials, out_path: str, n_channels: int = None,
                     fs: float = 62.5, channel_names=None) -> None:
    """Stacked multichannel trace plot of one trial (C, T), or of the
    first of (N, C, T), with matplotlib's Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arr = np.asarray(trials)
    if arr.ndim == 3:
        arr = arr[0]
    c, t = arr.shape
    if n_channels is not None:
        c = min(c, n_channels)
        arr = arr[:c]
    times = np.arange(t) / fs
    spread = np.std(arr) * 4 + 1e-9
    fig, ax = plt.subplots(figsize=(10, max(4, c * 0.4)))
    for i in range(c):
        ax.plot(times, arr[i] + (c - 1 - i) * spread, lw=0.6)
    ax.set_yticks([(c - 1 - i) * spread for i in range(c)])
    ax.set_yticklabels(channel_names[:c] if channel_names
                       else [f"ch{i}" for i in range(c)], fontsize=7)
    ax.set_xlabel("time [s]")
    fig.savefig(out_path, bbox_inches="tight", dpi=90)
    plt.close(fig)
