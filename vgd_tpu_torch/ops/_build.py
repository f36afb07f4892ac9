"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the source and
the flags and of the local headers it includes (``#include "..."``), so an
edited source or header is rebuilt and an unchanged one is reused.
Nothing here runs at import: the CPU tests import the package on machines
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ptxas report (registers, shared memory, spills) of each source built by
# this process, keyed by file name
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME, else the default
    toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _local_headers(src: Path, seen=None) -> List[Path]:
    """The headers ``src`` includes with quotes, found beside the file that
    includes them, and theirs in turn (each once, in include order)."""
    seen = [] if seen is None else seen
    for name in _LOCAL_INCLUDE.findall(src.read_bytes()):
        header = (src.parent / name.decode()).resolve()
        if header.exists() and header not in seen:
            seen.append(header)
            _local_headers(header, seen)
    return seen


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in _local_headers(src):
        digest.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> List[Path]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all started together; returns the library paths."""
    sources = [Path(s) for s in sources]
    outs = [_library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = []
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[src.name] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


def build_all() -> List[Path]:
    """Build every CUDA source of the package."""
    return build(sorted(CSRC_DIR.glob("*.cu")))


def _load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it with each C function's
    argument types declared (every function returns a CUDA error code)."""
    (path,) = build([CSRC_DIR / f"{name}.cu"])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.vgd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vgd_cuda_error_string.restype = ctypes.c_char_p
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def flash_attention_lib() -> ctypes.CDLL:
    """The flash-attention forward library (K3, and K2's forward)."""
    return _load("flash_attention", {
        "vgd_flash_attention_fwd": [_P] * 4 + [_I] * 4 + [_F, _P],
        "vgd_flash_attention_fwd_lse": [_P] * 5 + [_I] * 4 + [_F, _P]})


@functools.cache
def flash_attention_bwd_lib() -> ctypes.CDLL:
    """The flash-attention backward library (K2's dq and dk/dv)."""
    return _load("flash_attention_bwd", {
        "vgd_flash_attention_bwd_dq": [_P] * 7 + [_I] * 4 + [_F, _P],
        "vgd_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 6 + [_F, _P]})


@functools.cache
def conv_bn_stats_lib() -> ctypes.CDLL:
    """The fused Conv4x4s2 + batch-statistics library (K1)."""
    lib = _load("conv_bn_stats", {
        "vgd_conv_bn_stats": [_P] * 6 + [_I] * 11 + [ctypes.c_longlong, _P]})
    lib.vgd_conv_stats_part_floats.argtypes = [_I] * 8
    lib.vgd_conv_stats_part_floats.restype = ctypes.c_longlong
    return lib


@functools.cache
def glow_coupling_lib() -> ctypes.CDLL:
    """The Glow coupling-network library (K5: forward, backward 1 and 2)."""
    lib = _load("glow_coupling", {
        "vgd_glow_coupling_fwd": [_P] * 13 + [_I] * 11 + [_P],
        "vgd_glow_coupling_bwd1": [_P] * 20 + [_I] * 11 + [_P],
        "vgd_glow_coupling_bwd2": [_P] * 12 + [_I] * 11 + [_P]})
    lib.vgd_glow_coupling_part_floats.argtypes = [_I] * 10
    lib.vgd_glow_coupling_part_floats.restype = ctypes.c_longlong
    return lib


@functools.cache
def glow_flow_stack_lib() -> ctypes.CDLL:
    """The Glow flow-stack library (K6: forward with and without saving each
    flow's input, backward)."""
    lib = _load("glow_flow_stack", {
        "vgd_glow_flow_stack_fwd": [_P] * 14 + [_I] * 12 + [_P],
        "vgd_glow_flow_stack_bwd": [_P] * 27 + [_I] * 11 + [_P]})
    lib.vgd_glow_flow_stack_scratch_bytes.argtypes = [_I] * 11
    lib.vgd_glow_flow_stack_scratch_bytes.restype = ctypes.c_longlong
    lib.vgd_glow_flow_stack_grid.argtypes = [_I] * 2
    lib.vgd_glow_flow_stack_grid.restype = ctypes.c_int
    return lib
