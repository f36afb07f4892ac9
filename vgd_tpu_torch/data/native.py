"""The threaded C++ batch gather (``vgd_tpu/data/native.py``), bound with
ctypes.

``gather_batch(data, indices)`` assembles a minibatch from a uint8
(N, ...) array, the decoded memmap cache, with ``_native/gather.cpp``:
each of up to ``n_threads`` threads copies a contiguous range of the rows.
``gather_rows_at`` writes the rows at a row offset of a caller's buffer
(the training loop gathers a chunk's batches into its pinned staging
buffers in one call, ``utils/prefetch.py``). ``threads_for`` sizes the
thread count to the bytes of a call: starting a thread costs a fixed time,
which a one-batch gather of small images would not earn back.
``gather_batch_signed_f32`` fuses the uint8 -> [-1, 1] float32 conversion
into the gather, bit for bit the JAX package's native arithmetic.

The library is built from the source in the checkout at first use with the
host C++ compiler (``$CXX``, else ``g++`` or ``c++`` on PATH) into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source, the compiler and the flags, so an edited
source is rebuilt. Unlike the JAX package there is no numpy fallback: a
missing compiler, a failed build or a failed load raises. ``n_threads <=
1`` takes ``np.take``, a memcpy loop already, where the threads' start-up
would cost more than they save (single-core hosts), as the JAX package
does (with ``mode="clip"`` on indices checked beforehand: numpy buffers an
``out=`` of the default mode, a second pass). Nothing here runs at
import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "_native" / "gather.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
# bytes a gather thread must copy to earn its start-up: one thread per
# THREAD_GRAIN of a call (a thread copies ~4 MB a ms; starting one took
# ~0.2 ms on the 8-core host of an H100 machine, ``chip_smoke.py --only
# data``), so a 64x64 batch of 64 (0.79 MB) takes one thread, a 256x256
# one (12.6 MB) three, and a scan chunk all
THREAD_GRAIN = 4 << 20


@functools.cache
def default_threads() -> int:
    """The gather's default thread count: min(8, the host's cores), read
    once a process (``os.cpu_count`` reads a file on Linux)."""
    return min(8, os.cpu_count() or 1)


def threads_for(nbytes: int) -> int:
    """Threads for a gather of ``nbytes``: one a THREAD_GRAIN, at least one
    and at most ``default_threads()``."""
    return max(1, min(default_threads(), nbytes // THREAD_GRAIN))


def find_cxx() -> str:
    """Path of the host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on
    PATH."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, g++ or c++ on PATH): "
                       "the native batch gather (vgd_tpu_torch/data/_native/"
                       "gather.cpp) is built with g++ at first use")


def _library_path(cxx: str) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        [cxx] + CXX_FLAGS).encode())
    return BUILD_DIR / f"gather-{digest.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile ``_native/gather.cpp`` unless its library is up to date (or
    ``force``); returns the library's path. Raises with the compiler's
    message when the build fails."""
    cxx = find_cxx()
    out = _library_path(cxx)
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    """The gather library, built if needed and loaded once a process."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gather_rows_at.argtypes = [p, p, i64, i64, p, i64, i32]
    lib.gather_rows_signed_f32.argtypes = [p, p, i64, i64, p, i32]
    lib.gather_rows_at.restype = lib.gather_rows_signed_f32.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here (the error is raised by
    the gathers themselves)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _source(data: np.ndarray) -> np.ndarray:
    if data.dtype != np.uint8 or data.ndim < 1:
        raise ValueError(f"expected a uint8 (N, ...) array, got {data.dtype} "
                         f"{data.shape}")
    if not data.flags.c_contiguous:
        raise ValueError("the gather reads rows of a C-contiguous array")
    return data


def _rows(data: np.ndarray, indices) -> np.ndarray:
    """``indices`` as contiguous int64, each in [0, len(data))."""
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-d, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= len(data)):
        raise IndexError(f"indices outside [0, {len(data)})")
    return idx


def gather_rows_at(data: np.ndarray, indices, dst: np.ndarray, row: int,
                   n_threads: Optional[int] = None) -> None:
    """dst[row + i] = data[indices[i]]: rows [row, row + len(indices)) of a
    C-contiguous uint8 ``dst`` whose rows are ``data``'s; no other byte of
    ``dst`` is written."""
    data = _source(data)
    idx = _rows(data, indices)
    if (dst.dtype != np.uint8 or not dst.flags.c_contiguous
            or not dst.flags.writeable or dst.shape[1:] != data.shape[1:]):
        raise ValueError(f"dst must be a writeable C-contiguous uint8 array "
                         f"of rows {data.shape[1:]}, got {dst.dtype} "
                         f"{dst.shape}")
    if row < 0 or row + len(idx) > len(dst):
        raise IndexError(f"rows [{row}, {row + len(idx)}) outside dst's "
                         f"{len(dst)}")
    n_threads = n_threads or default_threads()
    if n_threads <= 1:
        np.take(data, idx, axis=0, out=dst[row:row + len(idx)], mode="clip")
        return
    _lib().gather_rows_at(
        data.ctypes.data, idx.ctypes.data, len(idx),
        int(np.prod(data.shape[1:])), dst.ctypes.data, row, n_threads)


def gather_batch(data: np.ndarray, indices, out: Optional[np.ndarray] = None,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """out[i] = data[indices[i]] for a uint8 (N, ...) array; ``out`` (made
    when None) has len(indices) rows."""
    data = _source(data)
    if out is None:
        out = np.empty((len(indices),) + data.shape[1:], np.uint8)
    elif len(out) != len(indices):
        raise ValueError(f"out has {len(out)} rows for {len(indices)} "
                         f"indices")
    gather_rows_at(data, indices, out, 0, n_threads)
    return out


def gather_batch_signed_f32(data: np.ndarray, indices,
                            n_threads: Optional[int] = None) -> np.ndarray:
    """Fused gather + uint8 -> [-1, 1] float32 (host-side consumers)."""
    data = _source(data)
    idx = _rows(data, indices)
    out = np.empty((len(idx),) + data.shape[1:], np.float32)
    _lib().gather_rows_signed_f32(
        data.ctypes.data, idx.ctypes.data, len(idx),
        int(np.prod(data.shape[1:])), out.ctypes.data,
        n_threads or default_threads())
    return out


if __name__ == "__main__":
    print("built", build(force=True))
