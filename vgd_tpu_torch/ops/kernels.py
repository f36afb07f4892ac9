"""The port's kernels and their plain PyTorch versions.

Counterpart of ``vgd_tpu/ops/pallas_kernels.py`` and of the kernels of
``vgd_tpu/ops/fused_conv.py``, ``vgd_tpu/ops/glow_coupling.py`` and
``vgd_tpu/ops/glow_flow_stack.py``:

* ``attention`` (K2, training: forward with logsumexp, dq, dk/dv) -> the
  CUDA kernels in ``csrc/flash_attention.cu`` (forward) and
  ``csrc/flash_attention_bwd.cu`` (backward), bound as a
  ``torch.autograd.Function``;
* ``flash_attention`` (K3, serving) -> the CUDA kernel in
  ``csrc/flash_attention.cu``;
* ``groupnorm_silu`` (K4, serving: GroupNorm + SiLU with the casts and the
  residual add around it) -> the CUDA kernel in ``csrc/groupnorm_silu.cu``
  under ``groupnorm_silu_plan``;
* ``conv_stats`` (K1, VAE-GAN training: Conv4x4 stride 2 with the
  per-channel batch statistics of its output) -> the CUDA kernels in
  ``csrc/conv_bn_stats.cu``; ``ops/fused_conv.py`` builds the
  differentiable Conv + BatchNorm + LeakyReLU on it;
* ``glow_coupling_fwd``, ``glow_coupling_bwd1``, ``glow_coupling_bwd2`` (K5,
  Glow training and sampling: the coupling network's forward and its two
  backward passes) -> the CUDA kernels in ``csrc/glow_coupling.cu``;
  ``ops/glow_coupling.py`` packs the weights and binds them as a
  ``torch.autograd.Function``;
* ``glow_flow_stack_fwd`` (with and without saving each flow's input) and
  ``glow_flow_stack_bwd`` (K6, Glow training with ``flow_stack``: a chunk
  of flows of one block per launch) -> the persistent CUDA kernels in
  ``csrc/glow_flow_stack.cu``; ``ops/glow_flow_stack.py`` packs the weights
  and binds them as a ``torch.autograd.Function``.

K3, K4 and K5's forward, the kernels of the serving paths, are registered
PyTorch ops (``torch.library.custom_op``): ``vgd::flash_attention``,
``vgd::groupnorm_silu`` and ``vgd::glow_coupling_fwd``. Each op's CUDA
implementation is the kernel's wrapper (``flash_attention_cuda``,
``groupnorm_silu_cuda``, ``glow_coupling_fwd_cuda``, which read
``LAUNCHES``, ``plain_reference()`` and K4's plan and barrier words at run
time), its CPU implementation the plain version, and its fake
implementation the output's shape and dtype; so ``torch.export``
(``io/export.py``) records the op node on every device, never the plain
arithmetic, and an eager call takes the same path. The public functions
``flash_attention``, ``groupnorm_silu`` and ``glow_coupling_fwd`` call the
ops after checking the devices.

Each wrapper takes its plain version only for a tensor that lies on the CPU
(the tests); for a CUDA tensor it launches the kernel or raises. There is
no fallback; the one size gate is ``attention``'s (``MIN_FLASH_ELEMS``, set
below the JAX package's by measurement), which sends small attentions to the
plain form before any wrapper is called.
``LAUNCHES`` counts the wrapper calls that launched a kernel, so a run can
show that its main path went through them.

``plain_reference()`` is a context manager that routes every wrapper to its
plain version on any device. It exists so that ``chip_smoke.py`` and the
tests can run the same model on the card with no kernel at all, as the
reference the kernels are held against; nothing in the package enters it.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vgd_tpu_torch.ops import _build

LAUNCHES: collections.Counter = collections.Counter()

_PLAIN_REFERENCE = False


@contextlib.contextmanager
def plain_reference() -> Iterator[None]:
    """Inside the block every wrapper computes its plain version, on the
    card too, and launches nothing: the kernel-free reference of
    ``chip_smoke.py`` and the tests."""
    global _PLAIN_REFERENCE
    before, _PLAIN_REFERENCE = _PLAIN_REFERENCE, True
    try:
        yield
    finally:
        _PLAIN_REFERENCE = before


def _check_devices(*tensors: torch.Tensor) -> None:
    """Raises unless every tensor is on the CPU or all are on one CUDA
    device. The registered ops' wrappers check before dispatch, so a meta
    tensor or a mix of devices never reaches an implementation (under
    ``torch.export`` the fake tensors report the device they stand for)."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"} or (types == {"cuda"}
                            and len({t.device for t in tensors}) == 1):
        return
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA "
                     f"device, got {[str(t.device) for t in tensors]}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (or inside ``plain_reference``),
    False when every one is on a CUDA device; raises on a mix or another
    device."""
    if _PLAIN_REFERENCE and {t.device.type for t in tensors} <= {"cpu",
                                                                 "cuda"}:
        return True
    _check_devices(*tensors)
    return tensors[0].device.type == "cpu"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K3: single-head attention
# ---------------------------------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Full-matrix attention (the math of ``attention_xla``).
    q (B, N, D), k/v (B, M, D) -> (B, N, D)."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.einsum("bnd,bmd->bnm", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnm,bmd->bnd", probs.to(v.dtype).float(),
                        v.float()).to(q.dtype)


FLASH_HEAD_DIMS = (64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v through the registered op
    ``vgd::flash_attention``: K3 for CUDA tensors (``flash_attention_cuda``
    on contiguous copies where the operands are not contiguous), the plain
    version for CPU tensors, the output's shape under tracing."""
    _check_devices(q, k, v)
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    return _flash_attention_op(q, k, v, float(scale))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """K3, the op's CUDA implementation: f32, contiguous, head dim in
    ``FLASH_HEAD_DIMS``; ragged N and M are masked inside the kernel."""
    if _on_cpu(q, k, v):
        return attention_plain(q, k, v, scale)
    d = q.shape[-1]
    _require(q.ndim == 3 and k.ndim == 3 and v.ndim == 3,
             "flash_attention takes q (B, N, D), k/v (B, M, D)")
    b, n, _ = q.shape
    m = k.shape[1]
    _require(k.shape == (b, m, d) and v.shape == (b, m, d),
             f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
             f"v {tuple(v.shape)}")
    _require(d in FLASH_HEAD_DIMS,
             f"head dim {d} not in {FLASH_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _require(b <= 65535, f"batch {b} > 65535")
    o = torch.empty_like(q)
    lib = _build.flash_attention_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.vgd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, n, m, d, float(scale), stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.vgd_cuda_error_string(err).decode())
    LAUNCHES["flash_attention"] += 1
    return o


@torch.library.custom_op("vgd::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    # an exported program runs on layouts it was not traced with (a
    # .contiguous() that was a no-op at trace time is not in the graph)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), scale)


@_flash_attention_op.register_kernel("cpu")
def _(q, k, v, scale):
    return attention_plain(q, k, v, scale)


@_flash_attention_op.register_fake
def _(q, k, v, scale):
    return q.new_empty(q.shape)


# ---------------------------------------------------------------------------
# K2: differentiable single-head attention (FlashAttention-2 forward with the
# row logsumexp, dq and dk/dv backward)
# ---------------------------------------------------------------------------

def attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): softmax(q k^T scale) v and the row logsumexp of the scaled
    logits, lse (B, N) f32 (the math of ``_flash_fwd_lse_kernel``)."""
    s = torch.einsum("bnd,bmd->bnm", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bnm,bmd->bnd", p, v.float())
    return o.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, scale):
    """p = exp(q k^T scale - lse) and ds = p (dO v^T - delta) scale."""
    p = torch.exp(torch.einsum("bnd,bmd->bnm", q.float(), k.float())
                  * scale - lse[..., None])
    ds = p * (torch.einsum("bnd,bmd->bnm", do.float(), v.float())
              - delta[..., None]) * scale
    return p, ds


def attention_dq_plain(q, k, v, do, lse, delta, scale):
    """dq = ds k (the math of ``_flash_bwd_dq_kernel``); delta (B, N)."""
    _, ds = _p_ds(q, k, v, do, lse, delta, scale)
    return torch.einsum("bnm,bmd->bnd", ds, k.float())


def attention_dkv_plain(q, k, v, do, lse, delta, scale):
    """(dk, dv) = (ds^T q, p^T dO) (the math of ``_flash_bwd_dkv_kernel``)."""
    p, ds = _p_ds(q, k, v, do, lse, delta, scale)
    return (torch.einsum("bnm,bnd->bmd", ds, q.float()),
            torch.einsum("bnm,bnd->bmd", p, do.float()))


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the FlashAttention-2 formulas of
    ``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel``: p = exp(s - lse),
    ds = p (dp - delta) scale with delta = rowsum(dO o)."""
    delta = (do.float() * o.float()).sum(-1)
    return (attention_dq_plain(q, k, v, do, lse, delta, scale),
            *attention_dkv_plain(q, k, v, do, lse, delta, scale))


_DKV_KEYS = 64      # keys per block of the dk/dv kernel (resident)
_DKV_ROWS = 16      # q rows per tile it streams


def dkv_splits(b: int, n: int, m: int, sm_count: int) -> Tuple[int, int]:
    """(splits, rows_per_split) of the q rows for the dk/dv kernel. A block
    takes 211 KB of shared memory at D = 256, so one fits on an SM: one
    split while there are at least as many (batch, 64-key) blocks as SMs,
    else about two blocks per SM, in whole 16-row tiles, so the 64-key
    cross-attentions (one key block per image) still fill the card."""
    q_tiles = -(-n // _DKV_ROWS)
    blocks = b * -(-m // _DKV_KEYS)
    splits = 1 if blocks >= sm_count else \
        min(q_tiles, max(1, 2 * sm_count // blocks))
    tiles_per_split = -(-q_tiles // splits)
    return -(-q_tiles // tiles_per_split), tiles_per_split * _DKV_ROWS


def _check_attention_inputs(what, tensors, b, n, m, d):
    _require(d in FLASH_HEAD_DIMS, f"head dim {d} not in {FLASH_HEAD_DIMS}")
    _require(b <= 65535, f"batch {b} > 65535")
    for name, t, shape in tensors:
        _require(tuple(t.shape) == shape,
                 f"{what}: {name} has shape {tuple(t.shape)}, want {shape}")
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.vgd_cuda_error_string(err).decode())


def attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 forward: (o, lse (B, N)). On CUDA: f32, contiguous, head dim in
    ``FLASH_HEAD_DIMS``; ragged N and M are masked in the kernel."""
    if _on_cpu(q, k, v):
        return attention_fwd_lse_plain(q, k, v, scale)
    _require(q.ndim == 3 and k.ndim == 3,
             "attention takes q (B, N, D), k/v (B, M, D)")
    b, n, d = q.shape
    m = k.shape[1]
    _check_attention_inputs("attention_fwd", [
        ("q", q, (b, n, d)), ("k", k, (b, m, d)), ("v", v, (b, m, d))],
        b, n, m, d)
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    lib = _build.flash_attention_lib()
    with torch.cuda.device(q.device):
        err = lib.vgd_flash_attention_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, n, m, d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "attention_fwd")
    LAUNCHES["attention_fwd"] += 1
    return o, lse


def _bwd_inputs(what, q, k, v, do, lse, delta):
    b, n, d = q.shape
    m = k.shape[1]
    _check_attention_inputs(what, [
        ("q", q, (b, n, d)), ("k", k, (b, m, d)), ("v", v, (b, m, d)),
        ("do", do, (b, n, d)), ("lse", lse, (b, n)),
        ("delta", delta, (b, n))], b, n, m, d)
    return b, n, m, d


def attention_dq(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """K2 dq kernel: q/do (B, N, D), k/v (B, M, D), lse/delta (B, N)."""
    if _on_cpu(q, k, v, do, lse, delta):
        return attention_dq_plain(q, k, v, do, lse, delta, scale)
    b, n, m, d = _bwd_inputs("attention_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    lib = _build.flash_attention_bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.vgd_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, n, m, d,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "attention_dq")
    LAUNCHES["attention_dq"] += 1
    return dq


def attention_dkv(q, k, v, do, lse, delta, scale
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 dk/dv kernel, splitting the q rows per ``dkv_splits`` (partial
    sums in a scratch buffer, added up in a fixed order)."""
    if _on_cpu(q, k, v, do, lse, delta):
        return attention_dkv_plain(q, k, v, do, lse, delta, scale)
    b, n, m, d = _bwd_inputs("attention_dkv", q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    splits, rows = dkv_splits(b, n, m, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    scratch = (torch.empty((2, splits, b, m, d), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    lib = _build.flash_attention_bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.vgd_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n, m, d,
            splits, rows, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "attention_dkv")
    LAUNCHES["attention_dkv"] += 1
    return dk, dv


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 backward: delta = rowsum(dO o) (one elementwise pass, as the JAX
    package leaves it to XLA), then the dq and the dk/dv kernels."""
    if _on_cpu(q, k, v, o, lse, do):
        return attention_bwd_plain(q, k, v, o, lse, do, scale)
    _require(o.shape == q.shape and o.dtype == q.dtype,
             f"attention_bwd: o has shape {tuple(o.shape)}, want "
             f"{tuple(q.shape)}")
    delta = (do * o).sum(-1)
    return (attention_dq(q, k, v, do, lse, delta, scale),
            *attention_dkv(q, k, v, do, lse, delta, scale))


class _Attention(torch.autograd.Function):
    """Counterpart of ``_flash_attention_diff``'s custom VJP: the forward
    saves (q, k, v, o, lse), the backward recomputes the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do.contiguous(),
                                   ctx.scale)
        return dq, dk, dv, None


# Attentions with N * M below this take the plain full-matrix form. The JAX
# package gates at 2^20; the port gates at 2^18, so that the UNet's
# cross_attn3 (B 16, N 4096, M 64, D 256: N * M = 2^18) runs K2: there K2
# under autograd (forward, delta, dq, dk/dv) measured 0.6009 ms (p90
# 0.6055) against 0.6417 ms (p90 0.6479) for the plain full-matrix form on
# an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's K2 gate line, PERF.md
# Findings). The rule: gate a site where K2 measures slower, not where it
# is no slower.
MIN_FLASH_ELEMS = 1 << 18


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable softmax(q k^T scale) v, the counterpart of
    ``attention`` in ``vgd_tpu/ops/pallas_kernels.py``. q (B, N, D), k/v
    (B, M, D). As there, N * M below a size gate takes the plain
    full-matrix attention (the port's ``MIN_FLASH_ELEMS``, 2^18, below the
    JAX package's 2^20) (differentiated by autograd, no launch); every
    larger call runs the K2 kernels on CUDA. Inside ``plain_reference()``
    it is always the plain form."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    if _PLAIN_REFERENCE or q.shape[1] * k.shape[1] < MIN_FLASH_ELEMS:
        return attention_plain(q, k, v, scale)
    return _Attention.apply(q, k, v, scale)


# ---------------------------------------------------------------------------
# K4: GroupNorm + SiLU
# ---------------------------------------------------------------------------

def groupnorm_silu_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int = 8,
                         eps: float = 1e-5, *,
                         out_dtype: Optional[torch.dtype] = None,
                         residual: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """GroupNorm over (H, W, C/G) then SiLU of x in f32, NHWC, two-pass f32
    variance (the math of ``groupnorm_silu_xla`` on ``x.astype(F32)``);
    then ``residual`` (upcast) added in f32 if given, and the result cast
    to ``out_dtype`` (default x's dtype): what ``vgd_tpu/models/unet.py``
    ConvBlock computes around its two ``GroupNormSiLU`` calls."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).float()
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = xn * scale + bias
    y = y * torch.sigmoid(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype if out_dtype is None else out_dtype)


class GroupNormPlan(NamedTuple):
    """How K4 runs one shape (``groupnorm_silu_plan``)."""
    threads: int        # per CTA: a multiple of C / 8 (8 channels a thread)
    cpi: int            # CTAs per image
    ipw: int            # images per wave; the grid is cpi * ipw CTAs
    waves: int
    run_pix: int        # pixels of a CTA's run (an image's last run: less)
    tile_pix: int       # pixels the buffer holds (run_pix when resident)
    tiles: int          # tiles per run: 1 when resident
    mode: str           # "resident" or "streamed"
    refill: bool        # the next wave's run loads during the apply pass
    buf_bytes: int      # the buffer
    smem: int           # dynamic shared memory per CTA
    per_sm: int         # CTAs an SM holds at once

    @property
    def grid(self) -> int:
        return self.cpi * self.ipw


# csrc/groupnorm_silu.cu: threads a CTA at most, channels, groups and CTAs an
# image at most, and the shared memory besides the buffer (kAuxBytes: the
# cross-thread reduction, per-group sums, the mbarrier)
_K4_THREADS, _K4_MAX_C, _K4_MAX_GROUPS, _K4_MAX_CPI = 256, 2048, 32, 512
K4_AUX_BYTES = _K4_THREADS * 8 * 4 + 4 * _K4_MAX_GROUPS * 4 + 16
# the H100's shared memory a block may opt into (227 KB)
K4_SMEM_BYTES = 232448
# an SM's shared memory (228 KB) and what the system keeps of it a block
K4_SM_SMEM, K4_BLOCK_RESERVED = 233472, 1024
# device times block 0 stamps a wave (``stamps``)
K4_STAMPS = 6
# barrier words, one per image of a wave on a 128-byte line of its own
# (kSyncStride words apart), kept per device and stream
_K4_SYNC_STRIDE = 32
_K4_SYNC_WORDS = 1024 * _K4_SYNC_STRIDE
_K4_SYNC: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _k4_check(c: int, groups: int) -> None:
    _require(c % groups == 0, f"channels {c} not a multiple of {groups}")
    _require(c % 8 == 0 and 8 <= c <= _K4_MAX_C,
             f"channels {c}: K4 takes a multiple of 8 up to {_K4_MAX_C}")
    _require(1 <= groups <= _K4_MAX_GROUPS,
             f"groups {groups} not in 1..{_K4_MAX_GROUPS}")


def groupnorm_silu_plan(b: int, h: int, w: int, c: int, groups: int = 8,
                        in_dtype: torch.dtype = torch.float32,
                        sm_count: int = 132,
                        smem_bytes: int = K4_SMEM_BYTES,
                        per_sm: int = 2) -> GroupNormPlan:
    """K4's plan for one shape: ``per_sm`` CTAs an SM (two: measured for
    both input types, ``PERF.md`` §6), each image spread
    over ``cpi`` CTAs as contiguous runs of whole pixels, as many images a
    wave as one buffer a CTA holds, the images then spread evenly over the
    waves ("resident": a run stays in shared memory between its statistics
    and its apply pass, and with several waves the next wave's run refills
    the buffer during the apply pass). An image the whole grid cannot hold
    runs "streamed": one image a wave, each run cut into tiles that pass
    through the buffer twice."""
    _k4_check(c, groups)
    es = torch.empty((), dtype=in_dtype).element_size()
    u = c // 8
    threads = u * (_K4_THREADS // u)
    hw, pix = h * w, c * es
    smem_bytes = min(smem_bytes, K4_SM_SMEM // per_sm - K4_BLOCK_RESERVED)
    budget = (smem_bytes - K4_AUX_BYTES) // 128 * 128
    sm_count = sm_count * per_sm

    def runs(ipw):                # (pixels a run, CTAs an image)
        rp = -(-hw // max(min(sm_count // ipw, _K4_MAX_CPI), 1))
        return rp, -(-hw // rp)

    def buf(pixels):
        return -(-pixels * pix // 128) * 128

    fits = [ipw for ipw in range(1, min(b, sm_count) + 1)
            if buf(runs(ipw)[0]) <= budget]
    if fits:
        waves = -(-b // max(fits))
        ipw = -(-b // waves)
        rp, cpi = runs(ipw)
        return GroupNormPlan(threads, cpi, ipw, waves, rp, rp, 1, "resident",
                             waves > 1, buf(rp), buf(rp) + K4_AUX_BYTES,
                             per_sm)
    rp, cpi = runs(1)
    tile = budget // pix
    _require(tile >= 1, f"a pixel of {c} channels does not fit K4's buffer")
    return GroupNormPlan(threads, cpi, 1, b, rp, tile, -(-rp // tile),
                         "streamed", False, buf(tile),
                         buf(tile) + K4_AUX_BYTES, per_sm)


@functools.lru_cache(maxsize=None)
def _k4_plan(b, h, w, c, groups, in_dtype, sm_count, smem_bytes):
    return groupnorm_silu_plan(b, h, w, c, groups, in_dtype, sm_count,
                               smem_bytes)


def _k4_sync(dev: torch.device) -> torch.Tensor:
    """Barrier words for a launch on the current stream: one buffer per
    (device, stream), zero when made. Every launch leaves each word's count
    at zero and launches on one stream run in order, so launches on other
    streams never share its words. A graph captured on a stream that has a
    buffer uses it, so it must not replay while K4 runs eagerly on that
    stream; where the capture stream has none yet, each captured call gets
    a zeroed buffer of its own, its zeroing captured with it (a buffer made
    during a capture is not zeroed until the graph replays)."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    sync = _K4_SYNC.get(key)
    if sync is None:
        sync = torch.zeros(_K4_SYNC_WORDS, dtype=torch.int32, device=dev)
        if not torch.cuda.is_current_stream_capturing():
            _K4_SYNC[key] = sync
    return sync


def _k4_stamps(stamps, plan, like):
    """The stamps buffer's address (None: no tracing), checked."""
    if stamps is None:
        return None
    _require(stamps.dtype == torch.int64 and stamps.is_contiguous()
             and stamps.numel() >= K4_STAMPS * plan.waves
             and stamps.device == like.device,
             f"K4: stamps must be a contiguous int64 tensor of at least "
             f"{K4_STAMPS * plan.waves} on {like.device}")
    return stamps.data_ptr()


def _k4_card(dev: torch.device) -> Tuple[int, int]:
    """(SMs, opt-in shared memory per block) of the card."""
    props = torch.cuda.get_device_properties(dev)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", K4_SMEM_BYTES))


_K4_DTYPES = (torch.float32, torch.bfloat16)


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 8, eps: float = 1e-5, *,
                   out_dtype: Optional[torch.dtype] = None,
                   residual: Optional[torch.Tensor] = None,
                   plan: Optional[GroupNormPlan] = None,
                   stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused GroupNorm(groups) + SiLU of x (B, H, W, C) in f32, plus
    ``residual`` if given, cast to ``out_dtype`` (default x's dtype): the
    function of ``groupnorm_silu_plain``, through the registered op
    ``vgd::groupnorm_silu`` (K4 for CUDA tensors, on contiguous copies where
    they are not; the plain version for CPU tensors). ``plan`` and
    ``stamps``, which only the kernel's own checks pass (``chip_smoke.py``),
    call ``groupnorm_silu_cuda`` directly."""
    operands = (x, scale, bias) + (() if residual is None else (residual,))
    if plan is not None or stamps is not None:
        return groupnorm_silu_cuda(x, scale, bias, groups, eps,
                                   out_dtype=out_dtype, residual=residual,
                                   plan=plan, stamps=stamps)
    _check_devices(*operands)
    return _groupnorm_silu_op(x, scale, bias, int(groups), float(eps),
                              out_dtype, residual)


def groupnorm_silu_cuda(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, groups: int = 8,
                        eps: float = 1e-5, *,
                        out_dtype: Optional[torch.dtype] = None,
                        residual: Optional[torch.Tensor] = None,
                        plan: Optional[GroupNormPlan] = None,
                        stamps: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K4, the op's CUDA implementation. x and the residual f32 or bf16,
    contiguous and 16-byte aligned; scale and bias f32 (C,); C a multiple
    of 8 and of ``groups``; ``plan`` defaults to ``groupnorm_silu_plan`` of
    the shape on this card. ``stamps`` (an int64 tensor of K4_STAMPS x
    plan.waves) makes block 0 record the device clock (ns) at each wave's
    phases: start, run loaded, statistics, barrier, merge, apply
    (``chip_smoke.k4_phases``). The plan cache and the barrier words
    (``_k4_sync``) are touched here only."""
    operands = (x, scale, bias) + (() if residual is None else (residual,))
    if _on_cpu(*operands):
        return groupnorm_silu_plain(x, scale, bias, groups, eps,
                                    out_dtype=out_dtype, residual=residual)
    _require(x.ndim == 4, "groupnorm_silu takes x (B, H, W, C)")
    b, h, w, c = x.shape
    _k4_check(c, groups)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _require(scale.shape == (c,) and bias.shape == (c,),
             f"scale/bias must have shape ({c},)")
    for name, t in (("scale", scale), ("bias", bias)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    named = (("x", x),) + (() if residual is None else
                           (("residual", residual),))
    for name, t in named:
        _require(t.dtype in _K4_DTYPES,
                 f"{name} must be float32 or bfloat16, got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
        _require(t.shape == x.shape, f"{name} has shape {tuple(t.shape)}, "
                 f"want {tuple(x.shape)}")
    _require(out_dtype in _K4_DTYPES,
             f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    _require(b * h * w >= 1, "groupnorm_silu takes a non-empty x")
    dev = x.device
    if plan is None:
        plan = _k4_plan(b, h, w, c, groups, x.dtype, *_k4_card(dev))
    lib = _build.groupnorm_silu_lib()
    y = torch.empty(x.shape, dtype=out_dtype, device=dev)
    part = torch.empty((4 * plan.ipw * plan.cpi * groups,),
                       dtype=torch.float32, device=dev)
    bf16 = torch.bfloat16
    res_kind = 0 if residual is None else 1 + (residual.dtype == bf16)
    with torch.cuda.device(dev):
        sync = _k4_sync(dev)
        err = lib.vgd_groupnorm_silu(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            y.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
            sync.data_ptr(), _K4_SYNC_WORDS, b, h * w, c, groups, float(eps),
            int(x.dtype == bf16), res_kind, int(out_dtype == bf16),
            plan.threads, plan.cpi, plan.ipw, plan.run_pix, plan.tile_pix,
            int(plan.refill), plan.buf_bytes, plan.smem,
            _k4_stamps(stamps, plan, x),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "groupnorm_silu")
    LAUNCHES["groupnorm_silu"] += 1
    return y


@torch.library.custom_op("vgd::groupnorm_silu", mutates_args=(),
                         device_types="cuda")
def _groupnorm_silu_op(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, groups: int, eps: float,
                       out_dtype: Optional[torch.dtype],
                       residual: Optional[torch.Tensor]) -> torch.Tensor:
    return groupnorm_silu_cuda(
        x.contiguous(), scale.contiguous(), bias.contiguous(), groups, eps,
        out_dtype=out_dtype,
        residual=None if residual is None else residual.contiguous())


@_groupnorm_silu_op.register_kernel("cpu")
def _(x, scale, bias, groups, eps, out_dtype, residual):
    return groupnorm_silu_plain(x, scale, bias, groups, eps,
                                out_dtype=out_dtype, residual=residual)


@_groupnorm_silu_op.register_fake
def _(x, scale, bias, groups, eps, out_dtype, residual):
    return x.new_empty(x.shape, dtype=x.dtype if out_dtype is None
                       else out_dtype)


def groupnorm_silu_sync_probe(rounds: int, cpi: int, ipw: int,
                              device) -> None:
    """Launches K4's exchange alone, ``rounds`` times: the per-image barrier
    words of ``ipw`` images of ``cpi`` CTAs; its cost, measured apart
    (``chip_smoke.py``). Counts no launch."""
    dev = torch.device(device)
    lib = _build.groupnorm_silu_lib()
    with torch.cuda.device(dev):
        err = lib.vgd_groupnorm_silu_sync_probe(
            int(rounds), int(cpi), int(ipw),
            _k4_sync(dev).data_ptr(), _K4_SYNC_WORDS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "groupnorm_silu_sync_probe")


# ---------------------------------------------------------------------------
# K1: Conv 4x4 stride 2 + per-channel batch statistics
# ---------------------------------------------------------------------------

def conv4x4s2_f32(x: torch.Tensor, w: torch.Tensor,
                  padding: int) -> torch.Tensor:
    """Conv 4x4 stride 2 in f32 of the upcast operands: x (B, H, W, Cin)
    NHWC, w (K, Cin, 4, 4) (torch's layout of the HWIO kernel) -> c
    (B, Ho, Wo, K) f32 (the conv of ``conv_bn_lrelu_xla``)."""
    return F.conv2d(x.float().permute(0, 3, 1, 2), w.float(), stride=2,
                    padding=padding).permute(0, 2, 3, 1)


def conv_stats_plain(x: torch.Tensor, w: torch.Tensor, padding: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(c, mean, var): ``conv4x4s2_f32`` and the per-channel mean and
    biased two-pass variance of c over (B, Ho, Wo)."""
    c = conv4x4s2_f32(x, w, padding)
    var, mean = torch.var_mean(c, dim=(0, 1, 2), correction=0)
    return c, mean, var


class ConvStatsPlan(NamedTuple):
    """How K1 runs one shape (``conv_stats_plan``)."""
    tile: int          # 0: f32 64 x 64 (FMA); bf16 1: 128 x 32 (mma.sync),
    #                    2: 128 x 64, 3: 128 x 128 (wgmma)
    bm: int            # output pixels per tile
    bn: int            # output channels per tile
    cin: int           # channels the kernel reads (x and w zero-padded to it)
    run: int           # elements per gather of A: 8 (16 bytes), 4 (f32) or 1
    m_tiles: int
    n_tiles: int
    splits: int        # pieces of the reduction (bf16), each k_split deep
    k_split: int
    stat_rows: int     # rows per (mean, M2) partial: bm, or 16 with splits
    part_floats: int   # scratch: the partials, then split partial tiles


# bf16 tiles of conv_bn_stats.cu: (rows, channels, resident blocks per SM)
_K1_TILES = {1: (128, 32, 5), 2: (128, 64, 3), 3: (128, 128, 2)}
_K1_STAGE = 64          # depth of one stage of the cp.async ring
_K1_MIN_SPLIT = 4       # stages per split at the least
_K1_SPLIT_ROWS = 16     # rows of the split sum's pieces


def _k1_splits(tiles: int, stages: int, resident: int, sm_count: int,
               splits: Optional[int]) -> Tuple[int, int]:
    """(splits, stages per split), unless ``splits`` is given: none while
    the output tiles occupy at least half the SMs (a split sum costs 6-10
    us, more than a second block an SM gains there), else as many as one
    wave of resident blocks holds, each at least _K1_MIN_SPLIT stages."""
    if splits is None:
        splits = 1 if 2 * tiles >= sm_count else \
            max(1, min(resident // tiles, stages // _K1_MIN_SPLIT))
    per = -(-stages // splits)
    return -(-stages // per), per


def conv_stats_plan(b: int, h: int, w: int, cin: int, k: int, padding: int,
                    *, bf16: bool = True, sm_count: int = 132,
                    tile: Optional[int] = None,
                    splits: Optional[int] = None) -> ConvStatsPlan:
    """K1's plan for one shape, which the wrapper passes to the C entry
    point. bf16: 1-3 channels padded to 4 with padding 0 and an even width
    (every 16-byte run is then two taps of one kernel row); A gathered in
    16-byte runs where Cin % 8 == 0 or in that padded case, else element by
    element; the tile by K: 128 x 32 (mma.sync) for K <= 32, 128 x 64
    for K <= 64, else 128 x 128 (both wgmma); the reduction cut into whole
    64-deep stages where the output tiles leave more than half of the
    ``sm_count`` SMs idle (``_k1_splits``). ``tile`` and ``splits``
    override the choice (``chip_smoke.py`` times other plans). f32: the
    64 x 64 FMA tile."""
    ho, wo = (h + 2 * padding - 4) // 2 + 1, (w + 2 * padding - 4) // 2 + 1
    m = b * ho * wo
    if not bf16:
        mt = -(-m // 64)
        return ConvStatsPlan(0, 64, 64, cin, 4 if cin % 4 == 0 else 1, mt,
                             -(-k // 64), 1, 16 * cin, 64, 2 * k * mt)
    pair = padding == 0 and w % 2 == 0
    kin = 4 if cin < 4 and pair else cin
    run = 8 if kin % 8 == 0 or (kin == 4 and pair) else 1
    stages = -(-16 * kin // _K1_STAGE)
    if tile is None:
        tile = 1 if k <= 32 else 2 if k <= 64 else 3
    bm, bn, per_sm = _K1_TILES[tile]
    mt, nt = -(-m // bm), -(-k // bn)
    splits, per = _k1_splits(mt * nt, stages, sm_count * per_sm, sm_count,
                             splits)
    if splits == 1:
        return ConvStatsPlan(tile, bm, bn, kin, run, mt, nt, 1,
                             per * _K1_STAGE, bm, 2 * k * mt)
    stats = 2 * k * -(-m // _K1_SPLIT_ROWS)
    return ConvStatsPlan(tile, bm, bn, kin, run, mt, nt, splits,
                         per * _K1_STAGE, _K1_SPLIT_ROWS,
                         -(-stats // 32) * 32 + splits * m * k)


def conv_stats(x: torch.Tensor, w: torch.Tensor, padding: int,
               plan: Optional[ConvStatsPlan] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: (c (B, Ho, Wo, K) f32, mean (K,), biased var (K,)) of the stride-2
    4x4 conv of x (B, H, W, Cin) with w (K, Cin, 4, 4), padding 0 or 1,
    accumulated in f32. On CUDA: x contiguous NHWC, bf16 or f32, w of the
    same dtype in any layout (the wrapper flattens it to the kernel's
    layout: bf16 (K, 16 Cin), f32 (16 Cin, K), depth (ky, kx, ci)); odd and
    ragged sizes are masked in the kernel;
    ``plan`` defaults to ``conv_stats_plan`` of the shape.
    Not differentiable: ``ops.fused_conv.conv_bn_lrelu`` is."""
    if _on_cpu(x, w):
        return conv_stats_plain(x, w, padding)
    _require(x.ndim == 4 and w.ndim == 4,
             "conv_stats takes x (B, H, W, Cin) and w (K, Cin, 4, 4)")
    b, h, wd, cin = x.shape
    k = w.shape[0]
    _require(tuple(w.shape) == (k, cin, 4, 4),
             f"w has shape {tuple(w.shape)}, want ({k}, {cin}, 4, 4)")
    _require(padding in (0, 1), f"padding {padding} not in (0, 1)")
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"x must be bfloat16 or float32, got {x.dtype}")
    _require(w.dtype == x.dtype, f"w is {w.dtype}, x is {x.dtype}")
    _require(x.is_contiguous(), "x must be contiguous (NHWC)")
    _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    ho, wo = (h + 2 * padding - 4) // 2 + 1, (wd + 2 * padding - 4) // 2 + 1
    _require(ho >= 1 and wo >= 1, f"input {h}x{wd} too small for a 4x4 "
             f"conv with padding {padding}")
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    if plan is None:
        plan = conv_stats_plan(
            b, h, wd, cin, k, padding, bf16=bf16,
            sm_count=torch.cuda.get_device_properties(dev).multi_processor_count)
    wt = w.permute(0, 2, 3, 1)                   # (K, 4, 4, Cin)
    if plan.cin != cin:
        x = F.pad(x, (0, plan.cin - cin))
        wt = F.pad(wt, (0, plan.cin - cin))
    wt = wt.reshape(k, 16 * plan.cin)
    wt = (wt if bf16 else wt.t()).contiguous()
    lib = _build.conv_bn_stats_lib()
    c = torch.empty((b, ho, wo, k), dtype=torch.float32, device=dev)
    part = torch.empty((plan.part_floats,), dtype=torch.float32, device=dev)
    mean = torch.empty((k,), dtype=torch.float32, device=dev)
    var = torch.empty((k,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vgd_conv_bn_stats(
            x.data_ptr(), wt.data_ptr(), c.data_ptr(), part.data_ptr(),
            mean.data_ptr(), var.data_ptr(), b, h, wd, plan.cin, k, padding,
            int(bf16), plan.tile, plan.splits, plan.k_split, plan.run,
            plan.part_floats, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "conv_bn_stats")
    LAUNCHES["conv_bn_stats"] += 1
    return c, mean, var


# ---------------------------------------------------------------------------
# K5: the Glow coupling network NN(ya) = ZeroConv(ReLU(Conv1x1(ReLU(
# Conv(ya))))) * exp(3 scale), forward and its two backward passes
# ---------------------------------------------------------------------------
#
# Packed layouts (``ops/glow_coupling.prep`` makes them from the model's HWIO
# weights): ya (B, H, W, cin) unpadded; w1f (kh*kw*cin, f) rows (tap, ci);
# w1t (kh*kw*f, cin) with w1t[(tap, k), ci] = W1[tap, ci, k]; w2 (f, f) and
# w2t = w2^T; wz (kh*kw*f, cout) rows (tap, k); wzf (kh*kw*cout, f) with
# wzf[(tap, c), k] = Wz[tap, k, c]; all in the compute dtype cd (ya's dtype).
# Biases, scale and the gradient g are f32. The conv is "same" (k = 2 pad + 1).

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of cd operands, summed in f32 (the operands upcast exactly)."""
    return a.float() @ b.float()


def _pad_hw(x: torch.Tensor, ph: int, pw: int, value: float) -> torch.Tensor:
    return F.pad(x, (0, 0, pw, pw, ph, ph), value=value)


def _im2col(xp: torch.Tensor, h: int, w: int, kh: int, kw: int
            ) -> torch.Tensor:
    """(B, h + kh - 1, w + kw - 1, C) -> (B*h*w, kh*kw*C), taps major."""
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(kh)
            for dx in range(kw)]
    return torch.cat(cols, -1).reshape(-1, kh * kw * xp.shape[-1])


def _coupling_hidden(ya, w1f, b1, w2, b2, khw, pad):
    """h1, h2 (B*H*W, f) in cd: ReLU in f32 after the f32 sums, then the
    rounding (``_recompute_fwd``)."""
    b, h, w, _ = ya.shape
    cd = ya.dtype
    cols = _im2col(_pad_hw(ya, pad[0], pad[1], 0.0), h, w, *khw)
    h1 = torch.relu(_mm(cols, w1f) + b1).to(cd)
    return h1, torch.relu(_mm(h1, w2) + b2).to(cd)


def _coupling_convz(h2, wz, bz, shape, khw, pad):
    """convz (B*H*W, cout) = conv of h2 padded with the value 1, + bz, in the
    shared-LHS N-pack form of the TPU kernel (``_zeroconv_fwd``) and of K5:
    r = h2 @ Wzr with Wzr[k, (tap, c)] = Wz[tap, k, c] on the interior; a
    border pixel's row of r is ones @ Wzr (the value 1 on every channel);
    then each tap's shifted slice of r, added in tap order."""
    b, h, w = shape
    (kh, kw), (ph, pw) = khw, pad
    taps, f, cout = kh * kw, h2.shape[-1], wz.shape[-1]
    wzr = wz.reshape(taps, f, cout).permute(1, 0, 2).reshape(f, taps * cout)
    edge = _mm(torch.ones((1, f), dtype=wzr.dtype, device=wzr.device), wzr)
    rp = edge.reshape(1, 1, 1, -1).repeat(b, h + 2 * ph, w + 2 * pw, 1)
    rp[:, ph:ph + h, pw:pw + w] = _mm(h2.reshape(-1, f), wzr).reshape(
        b, h, w, -1)
    convz = sum(rp[:, dy:dy + h, dx:dx + w,
                   (kw * dy + dx) * cout:(kw * dy + dx + 1) * cout]
                for dy in range(kh) for dx in range(kw))
    return convz.reshape(-1, cout) + bz


def glow_coupling_fwd_plain(ya, w1f, b1, w2, b2, wz, bz, scale, khw, pad
                            ) -> torch.Tensor:
    """NN(ya) (B, H, W, cout) f32 (the math of ``_fwd_kernel``)."""
    b, h, w, _ = ya.shape
    h1, h2 = _coupling_hidden(ya, w1f, b1, w2, b2, khw, pad)
    convz = _coupling_convz(h2, wz, bz, (b, h, w), khw, pad)
    return (convz * torch.exp(scale * 3.0)).reshape(b, h, w, -1)


def glow_coupling_bwd1_plain(ya, w1f, b1, w2, b2, wz, wzf, bz, scale, g, khw,
                             pad):
    """(h1, dh2 (B, H, W, f) in cd; dwz (f, kh*kw*cout), dbz, db2, dscale
    f32) (the math of ``_bwd1_kernel``): the forward recomputed, the
    ZeroConv's gradients with dWz over the value-1-padded grid, dh2 on the
    interior masked by the cd h2 > 0, db2 from the f32 dh2."""
    b, h, w, _ = ya.shape
    (kh, kw), (ph, pw) = khw, pad
    cd = ya.dtype
    h1, h2 = _coupling_hidden(ya, w1f, b1, w2, b2, khw, pad)
    f = h2.shape[-1]
    convz = _coupling_convz(h2, wz, bz, (b, h, w), khw, pad)
    cout = convz.shape[-1]
    gg = g.reshape(-1, cout).float()
    e = torch.exp(scale * 3.0)
    dscale = 3.0 * (gg * convz * e).sum(0)
    gs = gg * e
    dbz = gs.sum(0)
    gs16 = gs.to(cd).reshape(b, h, w, cout)
    # every tap's shifted placement of the gradient on the padded grid
    grid = torch.cat([F.pad(gs16, (0, 0, dx, 2 * pw - dx, dy, 2 * ph - dy))
                      .reshape(-1, cout) for dy in range(kh)
                      for dx in range(kw)], -1)
    h2p = _pad_hw(h2.reshape(b, h, w, f), ph, pw, 1.0).reshape(-1, f)
    dwz = _mm(h2p.t(), grid)
    # dh2 = correlation of the zero-padded gradient with the flipped taps
    wz_flipped = wzf.reshape(kh, kw, cout, f).flip(0, 1).reshape(-1, f)
    dh2 = _mm(_im2col(_pad_hw(gs16, ph, pw, 0.0), h, w, kh, kw), wz_flipped)
    dh2 = torch.where(h2.float() > 0, dh2, 0.0)
    return (h1.reshape(b, h, w, f), dh2.to(cd).reshape(b, h, w, f), dwz,
            dbz, dh2.sum(0), dscale)


def glow_coupling_bwd2_plain(ya, w1t, w2t, h1, dh2, khw, pad):
    """(dya (B, H, W, cin), dw1 (kh*kw*cin, f), db1, dw2 (f, f)) f32 (the
    math of ``_bwd2_kernel``): dh1 masked by the cd h1 > 0 and rounded to cd
    before dW1 and dya."""
    b, h, w, cin = ya.shape
    (kh, kw), (ph, pw) = khw, pad
    f = h1.shape[-1]
    h1f, dh2f = h1.reshape(-1, f), dh2.reshape(-1, f)
    dw2 = _mm(h1f.t(), dh2f)
    dh1 = torch.where(h1f.float() > 0, _mm(dh2f, w2t), 0.0)
    db1 = dh1.sum(0)
    dh1 = dh1.to(ya.dtype)
    cols = _im2col(_pad_hw(ya, ph, pw, 0.0), h, w, kh, kw)
    dw1 = _mm(cols.t(), dh1)
    taps = kh * kw
    w1r = w1t.reshape(taps, f, cin).permute(1, 0, 2).reshape(f, taps * cin)
    r2p = _pad_hw(_mm(dh1, w1r).reshape(b, h, w, taps * cin), ph, pw, 0.0)
    dya = sum(r2p[:, 2 * ph - dy:2 * ph - dy + h, 2 * pw - dx:2 * pw - dx + w,
                  (kw * dy + dx) * cin:(kw * dy + dx + 1) * cin]
              for dy in range(kh) for dx in range(kw))
    return dya, dw1, db1, dw2


def _k5_geometry(what, ya, f, cout, khw, pad, named):
    """Checks K5's operands on CUDA; returns the C functions' 11 ints."""
    _require(ya.ndim == 4, f"{what}: ya must be (B, H, W, cin)")
    b, h, w, cin = ya.shape
    (kh, kw), (ph, pw) = khw, pad
    _require(kh == 2 * ph + 1 and kw == 2 * pw + 1,
             f"{what}: kernel {khw} with padding {pad} is not a 'same' conv")
    _require(ya.dtype in (torch.bfloat16, torch.float32),
             f"{what}: ya must be bfloat16 or float32, got {ya.dtype}")
    # the bf16 tiles read every f-wide operand in 16-byte runs
    _require(ya.dtype == torch.float32 or f % 8 == 0,
             f"{what}: in bfloat16 the width f must be a multiple of 8, got "
             f"{f}")
    for name, t, shape, dtype in named:
        _require(tuple(t.shape) == shape,
                 f"{what}: {name} has shape {tuple(t.shape)}, want {shape}")
        _require(t.dtype == dtype, f"{what}: {name} is {t.dtype}, want "
                 f"{dtype}")
        _require(t.is_contiguous(), f"{what}: {name} must be contiguous")
        # the kernels read the activations and weights in 16-byte vectors
        _require(t.ndim == 1 or t.data_ptr() % 16 == 0,
                 f"{what}: {name} must be 16-byte aligned")
    return [b, h, w, cin, f, cout, kh, kw, ph, pw,
            int(ya.dtype == torch.bfloat16)]


def _k5_part(lib, dims, dev) -> torch.Tensor:
    n = lib.vgd_glow_coupling_part_floats(*dims[:10])
    _require(n > 0, f"K5: shape {dims[:10]} not supported")
    return torch.empty((n,), dtype=torch.float32, device=dev)


def _repack(t: torch.Tensor, taps: int, rows: int, cols: int
            ) -> torch.Tensor:
    """(taps * rows, cols) -> (taps * cols, rows), each tap's block
    transposed: wz -> wzf, w1t -> w1f."""
    return t.reshape(taps, rows, cols).transpose(1, 2).reshape(
        taps * cols, rows).contiguous()


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where a contiguous ``t`` does not start on 16 bytes
    (a flow's slice of a stacked weight can start anywhere; K5 reads its
    operands in 16-byte vectors)."""
    return t if not t.is_contiguous() or t.data_ptr() % 16 == 0 \
        else t.clone()


def glow_coupling_fwd(ya, w1f, b1, w2, b2, wz, bz, scale, khw, pad,
                      wzf=None) -> torch.Tensor:
    """K5 forward, NN(ya) (B, H, W, cout) f32, through the registered op
    ``vgd::glow_coupling_fwd`` (K5 for CUDA tensors, its operands first
    copied where they are not contiguous or not 16-byte aligned; the plain
    version for CPU tensors)."""
    _check_devices(ya, w1f, b1, w2, b2, wz, bz, scale)
    return _glow_coupling_fwd_op(ya, w1f, b1, w2, b2, wz, wzf, bz, scale,
                                 list(khw), list(pad))


def glow_coupling_fwd_cuda(ya, w1f, b1, w2, b2, wz, bz, scale, khw, pad,
                           wzf=None) -> torch.Tensor:
    """K5 forward, the op's CUDA implementation: every operand contiguous
    and 16-byte aligned, the weights in ya's dtype (bf16 or f32), in the
    packed layouts above; ragged sizes are masked in the kernel. ``wzf``,
    the ZeroConv weight in the wzf packing, is what the bf16 kernel reads
    (made from wz where not given)."""
    if _on_cpu(ya, w1f, b1, w2, b2, wz, bz, scale):
        return glow_coupling_fwd_plain(ya, w1f, b1, w2, b2, wz, bz, scale,
                                       khw, pad)
    cd, f32 = ya.dtype, torch.float32
    taps = khw[0] * khw[1]
    f, cout = w2.shape[0], bz.shape[0]
    cin = ya.shape[-1]
    if wzf is None:
        wzf = _repack(wz, taps, f, cout)
    dims = _k5_geometry("glow_coupling_fwd", ya, f, cout, khw, pad, [
        ("ya", ya, tuple(ya.shape), cd), ("w1f", w1f, (taps * cin, f), cd),
        ("b1", b1, (f,), f32), ("w2", w2, (f, f), cd), ("b2", b2, (f,), f32),
        ("wz", wz, (taps * f, cout), cd), ("wzf", wzf, (taps * cout, f), cd),
        ("bz", bz, (cout,), f32), ("scale", scale, (cout,), f32)])
    b, h, w = dims[:3]
    dev = ya.device
    out = torch.empty((b, h, w, cout), dtype=f32, device=dev)
    h1 = torch.empty((b * h * w, f), dtype=cd, device=dev)
    h2 = torch.empty_like(h1)
    lib = _build.glow_coupling_lib()
    part = _k5_part(lib, dims, dev)
    with torch.cuda.device(dev):
        err = lib.vgd_glow_coupling_fwd(
            *(t.data_ptr() for t in (ya, w1f, b1, w2, b2, wz, wzf, bz, scale,
                                     out, h1, h2, part)),
            *dims, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "glow_coupling_fwd")
    LAUNCHES["glow_coupling_fwd"] += 1
    return out


@torch.library.custom_op("vgd::glow_coupling_fwd", mutates_args=(),
                         device_types="cuda")
def _glow_coupling_fwd_op(ya: torch.Tensor, w1f: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, wz: torch.Tensor,
                          wzf: Optional[torch.Tensor], bz: torch.Tensor,
                          scale: torch.Tensor, khw: List[int],
                          pad: List[int]) -> torch.Tensor:
    return glow_coupling_fwd_cuda(
        *(aligned16(t.contiguous())
          for t in (ya, w1f, b1, w2, b2, wz, bz, scale)),
        tuple(khw), tuple(pad),
        wzf=None if wzf is None else aligned16(wzf.contiguous()))


@_glow_coupling_fwd_op.register_kernel("cpu")
def _(ya, w1f, b1, w2, b2, wz, wzf, bz, scale, khw, pad):
    return glow_coupling_fwd_plain(ya, w1f, b1, w2, b2, wz, bz, scale,
                                   tuple(khw), tuple(pad))


@_glow_coupling_fwd_op.register_fake
def _(ya, w1f, b1, w2, b2, wz, wzf, bz, scale, khw, pad):
    return ya.new_empty(tuple(ya.shape[:3]) + (bz.shape[0],),
                        dtype=torch.float32)


def glow_coupling_bwd1(ya, w1f, b1, w2, b2, wz, wzf, bz, scale, g, khw, pad):
    """K5 backward 1: (h1, dh2 (B, H, W, f) in cd; dwz (f, kh*kw*cout),
    dbz (cout,), db2 (f,), dscale (cout,) f32). g (B, H, W, cout) f32."""
    if _on_cpu(ya, w1f, b1, w2, b2, wz, wzf, bz, scale, g):
        return glow_coupling_bwd1_plain(ya, w1f, b1, w2, b2, wz, wzf, bz,
                                        scale, g, khw, pad)
    cd, f32 = ya.dtype, torch.float32
    taps = khw[0] * khw[1]
    f, cout = w2.shape[0], bz.shape[0]
    b, h, w, cin = ya.shape
    dims = _k5_geometry("glow_coupling_bwd1", ya, f, cout, khw, pad, [
        ("ya", ya, tuple(ya.shape), cd), ("w1f", w1f, (taps * cin, f), cd),
        ("b1", b1, (f,), f32), ("w2", w2, (f, f), cd), ("b2", b2, (f,), f32),
        ("wz", wz, (taps * f, cout), cd), ("wzf", wzf, (taps * cout, f), cd),
        ("bz", bz, (cout,), f32), ("scale", scale, (cout,), f32),
        ("g", g, (b, h, w, cout), f32)])
    dev = ya.device
    h1 = torch.empty((b, h, w, f), dtype=cd, device=dev)
    dh2, h2 = torch.empty_like(h1), torch.empty_like(h1)
    dwz = torch.empty((f, taps * cout), dtype=f32, device=dev)
    dbz, dscale = (torch.empty((cout,), dtype=f32, device=dev)
                   for _ in range(2))
    db2 = torch.empty((f,), dtype=f32, device=dev)
    convz = torch.empty((b * h * w, cout), dtype=f32, device=dev)
    # bf16: gs rows padded to a multiple of 8 channels (16-byte runs)
    gc = cout if cd == f32 else (cout + 7) // 8 * 8
    gs = torch.empty((b * h * w, gc), dtype=cd, device=dev)
    lib = _build.glow_coupling_lib()
    part = _k5_part(lib, dims, dev)
    with torch.cuda.device(dev):
        err = lib.vgd_glow_coupling_bwd1(
            *(t.data_ptr() for t in (ya, w1f, b1, w2, b2, wz, wzf, bz, scale,
                                     g, h1, dh2, dwz, dbz, db2, dscale, h2,
                                     convz, gs, part)),
            *dims, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "glow_coupling_bwd1")
    LAUNCHES["glow_coupling_bwd1"] += 1
    return h1, dh2, dwz, dbz, db2, dscale


def glow_coupling_bwd2(ya, w1t, w2t, h1, dh2, khw, pad, w1f=None):
    """K5 backward 2: (dya (B, H, W, cin), dw1 (kh*kw*cin, f), db1 (f,),
    dw2 (f, f)) f32, from backward 1's h1 and dh2. ``w1f``, the conv1 weight
    in the w1f packing, is what the bf16 kernel reads (made from w1t where
    not given)."""
    if _on_cpu(ya, w1t, w2t, h1, dh2):
        return glow_coupling_bwd2_plain(ya, w1t, w2t, h1, dh2, khw, pad)
    cd, f32 = ya.dtype, torch.float32
    taps = khw[0] * khw[1]
    b, h, w, cin = ya.shape
    f = w2t.shape[0]
    if w1f is None:
        w1f = _repack(w1t, taps, f, cin)
    # backward 2 never reads the ZeroConv's width: cout 1 stands for it
    dims = _k5_geometry("glow_coupling_bwd2", ya, f, 1, khw, pad, [
        ("ya", ya, tuple(ya.shape), cd), ("w1f", w1f, (taps * cin, f), cd),
        ("w1t", w1t, (taps * f, cin), cd),
        ("w2t", w2t, (f, f), cd), ("h1", h1, (b, h, w, f), cd),
        ("dh2", dh2, (b, h, w, f), cd)])
    dev = ya.device
    dya = torch.empty((b, h, w, cin), dtype=f32, device=dev)
    dw1 = torch.empty((taps * cin, f), dtype=f32, device=dev)
    db1 = torch.empty((f,), dtype=f32, device=dev)
    dw2 = torch.empty((f, f), dtype=f32, device=dev)
    dh1 = torch.empty((b, h, w, f), dtype=cd, device=dev)
    lib = _build.glow_coupling_lib()
    part = _k5_part(lib, dims, dev)
    with torch.cuda.device(dev):
        err = lib.vgd_glow_coupling_bwd2(
            *(t.data_ptr() for t in (ya, w1f, w1t, w2t, h1, dh2, dya, dw1,
                                     db1, dw2, dh1, part)),
            *dims, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "glow_coupling_bwd2")
    LAUNCHES["glow_coupling_bwd2"] += 1
    return dya, dw1, db1, dw2


# ---------------------------------------------------------------------------
# K6: a chunk of G Glow flows (ActNorm -> 1x1 conv -> additive coupling) of
# one block, forward with and without saving each flow's input, and backward
# ---------------------------------------------------------------------------
#
# x (B, H, W, c) f32; an_b, an_s (G, c) f32; wt (G, c, c) f32, the
# TRANSPOSED PLU weight (y2 = y1 @ wt); b1, b2 (G, f), bz, scale (G, ch) f32
# with ch = c / 2. The conv weights are packed per flow in cd, one row of
# ``k6_stride(n)`` elements per flow (n the flow's size, rounded up to a
# multiple of 8 so each flow starts 16-byte aligned), each flow's slice in
# K5's layout: w1f, w1t, w2, w2t, wz, wzf (``ops/glow_flow_stack._pack``).

K6_NAMES = ("glow_flow_stack_fwd", "glow_flow_stack_fwd_nosave",
            "glow_flow_stack_bwd")


def k6_stride(n: int) -> int:
    """Per-flow row length of a packed K6 weight of n elements."""
    return (n + 7) // 8 * 8


def _k6_flow(packed: torch.Tensor, k: int, rows: int, cols: int
             ) -> torch.Tensor:
    return packed[k, :rows * cols].reshape(rows, cols)


def _k6_invconv(x, an_b, an_s, wt, cd):
    """(cd(y1) (P, c), y2 (P, c) f32): ActNorm in f32, then the 1x1 conv of
    cd operands with f32 sums (K6 rounds here; the per-flow path does not)."""
    y1 = (an_s * (x + an_b)).reshape(-1, x.shape[-1]).to(cd)
    return y1, _mm(y1, wt.to(cd))


def glow_flow_stack_fwd_plain(x, an_b, an_s, wt, w1f, b1, w2, b2, wz, bz,
                              scale, khw, pad, save: bool):
    """y (B, H, W, c) f32 after the G flows, and with ``save`` also xsave
    (G, B, H, W, c), each flow's input (the math of ``_fwd_kernel`` /
    ``_fwd_sample_kernel``)."""
    b, h, w, c = x.shape
    ch, f, taps = c // 2, b1.shape[-1], khw[0] * khw[1]
    cd = w1f.dtype
    saved = []
    for k in range(an_b.shape[0]):
        if save:
            saved.append(x)
        _, y2 = _k6_invconv(x, an_b[k], an_s[k], wt[k], cd)
        ya = y2[:, :ch]
        nn = glow_coupling_fwd_plain(
            ya.to(cd).reshape(b, h, w, ch), _k6_flow(w1f, k, taps * ch, f),
            b1[k], _k6_flow(w2, k, f, f), b2[k],
            _k6_flow(wz, k, taps * f, ch), bz[k], scale[k], khw, pad)
        x = torch.cat([ya, y2[:, ch:] + nn.reshape(-1, ch)], -1).reshape(
            b, h, w, c)
    return (x, torch.stack(saved)) if save else x


def glow_flow_stack_bwd_plain(xsave, an_b, an_s, wt, w1f, w1t, b1, w2, w2t,
                              b2, wz, wzf, bz, scale, g, khw, pad):
    """(dx (B, H, W, c), d an_b, d an_s (G, c), dwt (G, c, c), dw1 (G,
    kh*kw*ch, f), db1 (G, f), dw2 (G, f, f), db2 (G, f), dwz (G, f,
    kh*kw*ch), dbz, dscale (G, ch)) f32 (the math of ``_bwd_kernel``): the
    flows in reverse, each recomputed from its saved input, the coupling's
    gradients as K5's two backward passes, then dy2 = cd([ga + dya, gb]),
    dwt = cd(y1)^T dy2, dy1 = dy2 cd(wt)^T, d an_s = sum dy1 (x + b),
    dx = dy1 s, d an_b = sum dx."""
    n_flows, b, h, w, c = xsave.shape
    ch, f, taps = c // 2, b1.shape[-1], khw[0] * khw[1]
    cd = w1f.dtype
    grads = [[None] * n_flows for _ in range(10)]
    g = g.float()
    for k in range(n_flows - 1, -1, -1):
        x = xsave[k]
        y1, y2 = _k6_invconv(x, an_b[k], an_s[k], wt[k], cd)
        ya = y2[:, :ch].to(cd).reshape(b, h, w, ch)
        gf = g.reshape(-1, c)
        h1, dh2, dwz, dbz, db2, dscale = glow_coupling_bwd1_plain(
            ya, _k6_flow(w1f, k, taps * ch, f), b1[k], _k6_flow(w2, k, f, f),
            b2[k], _k6_flow(wz, k, taps * f, ch),
            _k6_flow(wzf, k, taps * ch, f), bz[k], scale[k],
            gf[:, ch:].reshape(b, h, w, ch), khw, pad)
        dya, dw1, db1, dw2 = glow_coupling_bwd2_plain(
            ya, _k6_flow(w1t, k, taps * f, ch), _k6_flow(w2t, k, f, f), h1,
            dh2, khw, pad)
        dy2 = torch.cat([gf[:, :ch] + dya.reshape(-1, ch), gf[:, ch:]],
                        -1).to(cd)
        dwt = _mm(y1.t(), dy2)
        dy1 = _mm(dy2, wt[k].to(cd).t())
        dans = (dy1 * (x.reshape(-1, c) + an_b[k])).sum(0)
        dx = dy1 * an_s[k]
        for i, t in enumerate((dx.sum(0), dans, dwt, dw1, db1, dw2, db2, dwz,
                               dbz, dscale)):
            grads[i][k] = t
        g = dx.reshape(b, h, w, c)
    return (g, *(torch.stack(t) for t in grads))


# The bf16 kernels' tiles (rows, columns) by name, and the number the C entry
# points take; "f32" is the check path's 64 x 64 CUDA-core tile
K6_TILES = {"mma64": (64, 64, 0), "wgmma128x64": (128, 64, 1),
            "wgmma128": (128, 128, 2), "f32": (64, 64, -1)}
# the products of one flow, in the plan's order: (name, the tiles it may
# take, large first; splittable). The 64 x 64 mma.sync tile serves the
# forward's products at the small blocks; the backward runs those on wgmma
# too (the C entry point maps them), and every gradient product on wgmma.
K6_PRODUCTS = (("conv1", ("wgmma128", "mma64"), False),
               ("conv2", ("wgmma128", "mma64"), False),
               ("zconv", ("wgmma128x64", "mma64"), True),
               ("dwz", ("wgmma128x64",), True),
               ("dh2", ("wgmma128",), False),
               ("dw2", ("wgmma128",), True),
               ("dh1", ("wgmma128",), False),
               ("dw1", ("wgmma128",), True),
               ("dya", ("wgmma128x64",), True))
_K6_STAGE = 64          # depth of one ring stage (bf16)
_K6_MIN_SPLIT = 2       # ring stages per split at the least
_K6_PER_SM = 1          # resident blocks an SM (256 threads, 99 KB each)
_K6_PIX_FLOATS = 2048   # tp * c at most (one per-pixel array)
_K6_F32_CHUNK, _K6_F32_TARGET, _K6_F32_STACK = 32, 264, 64 * 68


class FlowStackProduct(NamedTuple):
    """One product of a flow as K6 runs it (``flow_stack_plan``)."""
    name: str
    tile: str          # a key of K6_TILES
    m: int
    n: int
    k: int
    m_tiles: int
    n_tiles: int
    splits: int        # pieces of the reduction, each k_split deep
    k_split: int


class FlowStackPlan(NamedTuple):
    """How K6 runs one block shape (``flow_stack_plan``)."""
    bf16: bool
    products: Tuple[FlowStackProduct, ...]   # K6_PRODUCTS' order
    ya_run: int        # elements per gather of ya's channels (conv1 and
    #                    dW1's A): 8 (16 bytes), 2 (4 bytes) or 1; f32: 4, 1
    tail_pixels: int   # pixels of one per-pixel unit
    units: int         # per-pixel units
    fwd_pieces: Tuple[Tuple[str, int], ...]  # scratch: (name, bytes)
    bwd_pieces: Tuple[Tuple[str, int], ...]
    syncs_per_flow: Tuple[int, int]          # grid syncs (forward, backward)
    syncs_fixed: Tuple[int, int]             # ... plus these a call

    def product(self, name: str) -> FlowStackProduct:
        return next(p for p in self.products if p.name == name)

    def scratch_bytes(self, backward: bool) -> int:
        return sum(b for _, b in (self.bwd_pieces if backward
                                  else self.fwd_pieces))

    def syncs(self, flows: int) -> Tuple[int, int]:
        """Grid syncs of one forward and one backward call over ``flows``."""
        return tuple(flows * n + c for n, c in zip(self.syncs_per_flow,
                                                   self.syncs_fixed))

    def ints(self) -> list:
        """The plan as the C entry points take it: (tile, splits, k_split)
        per product, then the unit's pixels."""
        out = []
        for p in self.products:
            out += [K6_TILES[p.tile][2], p.splits, p.k_split]
        return out + [self.tail_pixels]


def _k6_up(n: int) -> int:
    return -(-n // 256) * 256


def _k6_product(name, tiles, split, m, n, k, sm_count, tile=None,
                splits=None) -> FlowStackProduct:
    """The bf16 rule: an unsplit product takes its large tile where its
    tiles occupy at least half the SMs, else 64 x 64; a split one its large
    tile
    where both output sides fill it, and a split into whole stages (at least
    _K6_MIN_SPLIT each) where its tiles leave more than half the SMs idle,
    as many as one wave of resident blocks holds."""
    def grid(tile):
        bm, bn, _ = K6_TILES[tile]
        return -(-m // bm), -(-n // bn)
    big, chosen = tiles[0], tiles[-1]
    if not split and 2 * grid(big)[0] * grid(big)[1] >= sm_count:
        chosen = big
    if split and m >= K6_TILES[big][0] and n >= K6_TILES[big][1]:
        chosen = big
    if tile is not None:
        _require(tile in tiles, f"K6 {name}: tile {tile} not in {tiles}")
        chosen = tile
    mt, nt = grid(chosen)
    stages = -(-k // _K6_STAGE)
    if splits is None:
        splits = 1
        if split and 2 * mt * nt < sm_count:
            splits = max(1, min(stages // _K6_MIN_SPLIT,
                                _K6_PER_SM * sm_count // (mt * nt)))
    _require(split or splits == 1, f"K6 {name} is never split")
    splits = max(1, min(splits, stages))
    per = -(-stages // splits)
    return FlowStackProduct(name, chosen, m, n, k, mt, nt, -(-stages // per),
                            per * _K6_STAGE)


def _k6_f32_product(name, split, m, n, k) -> FlowStackProduct:
    """The f32 check path's rule (glow_gemm.cuh's split_k)."""
    mt, nt = -(-m // 64), -(-n // 64)
    chunks = -(-k // _K6_F32_CHUNK)
    s = 1
    if split:
        s = min(max(1, -(-_K6_F32_TARGET // (mt * nt))), chunks)
    per = -(-chunks // s)
    return FlowStackProduct(name, "f32", m, n, k, mt, nt, -(-chunks // per),
                            per * _K6_F32_CHUNK)


def flow_stack_plan(b: int, h: int, w: int, c: int, f: int,
                    khw: Tuple[int, int], *, bf16: bool = True,
                    sm_count: int = 132,
                    tiles: Optional[Dict[str, str]] = None,
                    splits: Optional[Dict[str, int]] = None
                    ) -> FlowStackPlan:
    """K6's plan for one block shape, which the wrapper passes to the C
    entry points (they check it): per product of a flow its tile (bf16:
    ``wgmma128`` / ``wgmma128x64`` on wgmma, or for the forward's conv1,
    conv2 and ZeroConv ``mma64`` on mma.sync, which the backward runs on
    wgmma) and its reduction split (``_k6_product``), the pixels of one
    per-pixel unit (about a unit an SM, at most _K6_PIX_FLOATS / c), the
    scratch pieces and the grid syncs. bf16 needs f % 8 == 0 (16-byte runs along f). f32:
    the check path's fixed design (64 x 64 tiles, its own split rule, 5 and
    10 syncs per flow). ``tiles`` / ``splits`` (product name -> tile /
    split count) override the bf16 choice (the gpu tests and
    ``chip_smoke.py`` run other plans)."""
    (kh, kw) = khw
    ch, taps = c // 2, kh * kw
    p = b * h * w
    q = b * (h + 2 * (kh // 2)) * (w + 2 * (kw // 2))
    if not bf16:
        shapes = {"conv1": (p, f, taps * ch), "conv2": (p, f, f),
                  "zconv": (p, ch, taps * f), "dwz": (f, taps * ch, q),
                  "dh2": (p, f, taps * ch), "dw2": (f, f, p),
                  "dh1": (p, f, f), "dw1": (taps * ch, f, p),
                  "dya": (p, ch, taps * f)}
        prods = tuple(_k6_f32_product(n, sp, *shapes[n])
                      for n, _, sp in K6_PRODUCTS)
        pr = {x.name: x for x in prods}
        tp = min(64, _K6_F32_STACK // (2 * c))
        units = -(-p // tp)
        fwd = (("ya", p * ch * 4), ("h1", p * f * 4), ("h2", p * f * 4),
               ("r", 4 * pr["zconv"].splits * p * ch), ("cur", 4 * 2 * p * c))
        bwd = (("ya", p * ch * 4), ("h1", p * f * 4), ("h2", p * f * 4),
               ("r", 4 * pr["zconv"].splits * p * ch), ("dh2", p * f * 4),
               ("dh1", p * f * 4), ("gs", p * ch * 4), ("convz", 4 * p * ch),
               ("pwz", 4 * pr["dwz"].splits * f * taps * ch),
               ("pw2", 4 * pr["dw2"].splits * f * f),
               ("pw1", 4 * pr["dw1"].splits * taps * ch * f),
               ("pya", 4 * pr["dya"].splits * p * ch),
               ("cp2", 4 * f * pr["dh2"].m_tiles),
               ("cp1", 4 * f * pr["dh1"].m_tiles),
               ("pdwt", 4 * units * c * c), ("pdans", 4 * units * c),
               ("pdanb", 4 * units * c))
        return FlowStackPlan(False, prods, 4 if ch % 4 == 0 else 1, tp, units,
                             tuple((n, _k6_up(x)) for n, x in fwd),
                             tuple((n, _k6_up(x)) for n, x in bwd),
                             (5, 10), (0, 1))
    gc = -(-ch // 8) * 8
    shapes = {"conv1": (p, f, taps * ch), "conv2": (p, f, f),
              "zconv": (p + 1, taps * ch, f), "dwz": (f, taps * gc, q),
              "dh2": (p, f, taps * gc), "dw2": (f, f, p), "dh1": (p, f, f),
              "dw1": (taps * ch, f, p), "dya": (p, taps * ch, f)}
    tiles, splits = tiles or {}, splits or {}
    prods = tuple(_k6_product(n, t, sp, *shapes[n], sm_count, tiles.get(n),
                              splits.get(n))
                  for n, t, sp in K6_PRODUCTS)
    pr = {x.name: x for x in prods}
    tp = 1
    while tp * sm_count < p:
        tp *= 2
    while tp > 1 and tp * c > _K6_PIX_FLOATS:
        tp //= 2
    units = -(-p // tp)
    z, y = pr["zconv"], pr["dya"]
    fwd = (("ya", p * ch * 2), ("h1", p * f * 2), ("h2", p * f * 2),
           ("r", 4 * z.splits * z.m * z.n), ("cur", 4 * p * c))
    bwd = (("ya", 2 * p * ch * 2), ("h1", 2 * p * f * 2), ("h2", p * f * 2),
           ("r", 4 * z.splits * z.m * z.n), ("dh2", p * f * 2),
           ("dh1", p * f * 2), ("gs", p * gc * 2),
           ("r2", 4 * y.splits * y.m * y.n),
           ("pwz", 4 * pr["dwz"].splits * f * taps * gc),
           ("cp2", 4 * pr["dh2"].m_tiles * f),
           ("pw2", 4 * pr["dw2"].splits * f * f),
           ("cp1", 4 * pr["dh1"].m_tiles * f),
           ("pw1", 4 * pr["dw1"].splits * taps * ch * f),
           ("pz", 4 * units * 2 * ch), ("ptail", 4 * units * (c * c + 2 * c)))
    run = 8 if ch % 8 == 0 else 2 if ch % 2 == 0 else 1
    return FlowStackPlan(True, prods, run, tp, units,
                         tuple((n, _k6_up(x)) for n, x in fwd),
                         tuple((n, _k6_up(x)) for n, x in bwd), (4, 4), (1, 6))


def _k6_transposed(packed: torch.Tensor, taps: int, rows: int, cols: int
                   ) -> torch.Tensor:
    """(G, k6_stride(taps rows cols)) of per-flow taps x (rows, cols) blocks
    -> the same with each block transposed: w2 -> w2t (taps 1), wz -> wzf."""
    g, n = packed.shape[0], taps * rows * cols
    t = packed[:, :n].reshape(g, taps, rows, cols).transpose(2, 3)
    return F.pad(t.reshape(g, n), (0, k6_stride(n) - n)).contiguous()


def _k6_dims(what, x, named, n_flows, f, khw, pad, cd):
    """Checks K6's operands on CUDA; returns the C functions' shape ints
    (flows, b, h, w, c, f, kh, kw, ph, pw, bf16)."""
    _require(x.ndim == 4 and x.shape[-1] % 2 == 0,
             f"{what}: x must be (B, H, W, c) with c even")
    b, h, w, c = x.shape
    (kh, kw), (ph, pw) = khw, pad
    _require(kh == 2 * ph + 1 and kw == 2 * pw + 1,
             f"{what}: kernel {khw} with padding {pad} is not a 'same' conv")
    _require(cd in (torch.bfloat16, torch.float32),
             f"{what}: the packed weights must be bfloat16 or float32, got "
             f"{cd}")
    _require(c <= 128, f"{what}: {c} flow channels (at most 128)")
    # the bf16 tiles read every f-wide operand in 16-byte runs
    _require(cd == torch.float32 or f % 8 == 0,
             f"{what}: in bfloat16 the width f must be a multiple of 8, got "
             f"{f}")
    for name, t, shape, dtype in named:
        _require(tuple(t.shape) == shape,
                 f"{what}: {name} has shape {tuple(t.shape)}, want {shape}")
        _require(t.dtype == dtype, f"{what}: {name} is {t.dtype}, want "
                 f"{dtype}")
        _require(t.is_contiguous(), f"{what}: {name} must be contiguous")
        # the GEMM stages read the packed weights in 16-byte vectors
        _require(t.data_ptr() % 16 == 0,
                 f"{what}: {name} must be 16-byte aligned")
    return [n_flows, b, h, w, c, f, kh, kw, ph, pw,
            int(cd == torch.bfloat16)]


def _k6_weights(n_flows, c, f, taps, cd, **operands):
    """(name, tensor, shape, dtype) of K6's per-flow operands for
    ``_k6_dims``: the packed conv weights in cd, the vectors and wt f32."""
    ch = c // 2
    packed = {"w1f": taps * ch * f, "w1t": taps * f * ch, "w2": f * f,
              "w2t": f * f, "wz": taps * f * ch, "wzf": taps * ch * f}
    plain = {"an_b": (c,), "an_s": (c,), "wt": (c, c), "b1": (f,),
             "b2": (f,), "bz": (ch,), "scale": (ch,)}
    return [(n, t, (n_flows, k6_stride(packed[n])), cd) if n in packed
            else (n, t, (n_flows,) + plain[n], torch.float32)
            for n, t in operands.items()]


def _k6_plan(dims, plan, dev) -> FlowStackPlan:
    """``plan``, or flow_stack_plan of the shape on ``dev``'s SM count."""
    if plan is not None:
        return plan
    _, b, h, w, c, f, kh, kw = dims[:8]
    return flow_stack_plan(
        b, h, w, c, f, (kh, kw), bf16=bool(dims[-1]),
        sm_count=torch.cuda.get_device_properties(dev).multi_processor_count)


def _k6_scratch(lib, dims, backward, plan_ints, dev) -> torch.Tensor:
    n = lib.vgd_glow_flow_stack_scratch_bytes(*dims[1:], int(backward),
                                              plan_ints)
    _require(n > 0, f"K6: shape {dims[1:10]} (or its plan) not supported")
    return torch.empty((n,), dtype=torch.uint8, device=dev)


def _k6_stamps(stamps, syncs, like):
    """The stamps buffer's address (None: no tracing), checked."""
    if stamps is None:
        return None
    _require(stamps.dtype == torch.int64 and stamps.is_contiguous()
             and stamps.numel() >= syncs + 1 and stamps.device == like.device,
             f"K6: stamps must be a contiguous int64 tensor of at least "
             f"{syncs + 1} on {like.device}")
    return stamps.data_ptr()


def _k6_ints(plan: FlowStackPlan):
    import ctypes
    ints = plan.ints()
    return (ctypes.c_int * len(ints))(*ints)


def glow_flow_stack_fwd(x, an_b, an_s, wt, w1f, b1, w2, b2, wz, bz, scale,
                        khw, pad, save: bool, *,
                        plan: Optional[FlowStackPlan] = None,
                        grid: int = 0, stamps: Optional[torch.Tensor] = None):
    """K6 forward: y (B, H, W, c) f32, and with ``save`` also xsave (G, B,
    H, W, c) f32. One launch for the G flows; on CUDA every operand is
    contiguous, the packed weights in cd (bf16 or f32; bf16 needs f % 8 ==
    0; its ZeroConv and conv2 read wz and w2 transposed, made here).
    ``plan`` defaults to ``flow_stack_plan`` of the shape; ``grid`` is the
    number of blocks to launch (0: every resident block; more is refused);
    ``stamps`` (bf16, int64, ``plan.syncs(G)[0] + 1`` long) receives the
    device clock in ns at the start and after each stage (tracing)."""
    if _on_cpu(x, an_b, an_s, wt, w1f, b1, w2, b2, wz, bz, scale):
        return glow_flow_stack_fwd_plain(x, an_b, an_s, wt, w1f, b1, w2, b2,
                                         wz, bz, scale, khw, pad, save)
    n_flows, c, f = an_b.shape[0], x.shape[-1], b1.shape[-1]
    taps = khw[0] * khw[1]
    dims = _k6_dims("glow_flow_stack_fwd", x, [
        ("x", x, tuple(x.shape), torch.float32),
        *_k6_weights(n_flows, c, f, taps, w1f.dtype, an_b=an_b, an_s=an_s,
                     wt=wt, w1f=w1f, b1=b1, w2=w2, b2=b2, wz=wz, bz=bz,
                     scale=scale)], n_flows, f, khw, pad, w1f.dtype)
    dev = x.device
    plan = _k6_plan(dims, plan, dev)
    ints = _k6_ints(plan)
    bf16 = w1f.dtype == torch.bfloat16
    w2t = _k6_transposed(w2, 1, f, f) if bf16 else w2
    wzf = _k6_transposed(wz, taps, f, c // 2) if bf16 else wz
    lib = _build.glow_flow_stack_lib()
    scratch = _k6_scratch(lib, dims, False, ints, dev)
    y = torch.empty_like(x)
    xsave = (torch.empty((n_flows,) + tuple(x.shape), dtype=torch.float32,
                         device=dev) if save else None)
    with torch.cuda.device(dev):
        err = lib.vgd_glow_flow_stack_fwd(
            *(t.data_ptr() for t in (x, an_b, an_s, wt, w1f, b1, w2, w2t, b2,
                                     wz, wzf, bz, scale, y)),
            None if xsave is None else xsave.data_ptr(), scratch.data_ptr(),
            ints, _k6_stamps(stamps, plan.syncs(n_flows)[0], x), *dims,
            int(save), int(grid),
            torch.cuda.current_stream(dev).cuda_stream)
    name = "glow_flow_stack_fwd" if save else "glow_flow_stack_fwd_nosave"
    _raise_on(lib, err, name)
    LAUNCHES[name] += 1
    return (y, xsave) if save else y


def glow_flow_stack_bwd(xsave, an_b, an_s, wt, w1f, w1t, b1, w2, w2t, b2, wz,
                        wzf, bz, scale, g, khw, pad, *,
                        plan: Optional[FlowStackPlan] = None,
                        grid: int = 0, stamps: Optional[torch.Tensor] = None):
    """K6 backward: the gradients of ``glow_flow_stack_bwd_plain``, one
    launch for the G flows. g (B, H, W, c) f32; ``plan``, ``grid`` and
    ``stamps`` (``plan.syncs(G)[1] + 1`` long) as the forward's."""
    if _on_cpu(xsave, an_b, an_s, wt, w1f, w1t, b1, w2, w2t, b2, wz, wzf, bz,
               scale, g):
        return glow_flow_stack_bwd_plain(xsave, an_b, an_s, wt, w1f, w1t, b1,
                                         w2, w2t, b2, wz, wzf, bz, scale, g,
                                         khw, pad)
    n_flows, c, f = an_b.shape[0], g.shape[-1], b1.shape[-1]
    taps = khw[0] * khw[1]
    ch, f32 = c // 2, torch.float32
    dims = _k6_dims("glow_flow_stack_bwd", g, [
        ("g", g, tuple(g.shape), f32),
        ("xsave", xsave, (n_flows,) + tuple(g.shape), f32),
        *_k6_weights(n_flows, c, f, taps, w1f.dtype, an_b=an_b, an_s=an_s,
                     wt=wt, w1f=w1f, w1t=w1t, b1=b1, w2=w2, w2t=w2t, b2=b2,
                     wz=wz, wzf=wzf, bz=bz, scale=scale)],
        n_flows, f, khw, pad, w1f.dtype)
    dev = g.device
    plan = _k6_plan(dims, plan, dev)
    ints = _k6_ints(plan)
    lib = _build.glow_flow_stack_lib()
    scratch = _k6_scratch(lib, dims, True, ints, dev)

    def out(*shape):
        return torch.empty((n_flows,) + shape, dtype=f32, device=dev)
    grads = (torch.empty_like(g), out(c), out(c), out(c, c),
             out(taps * ch, f), out(f), out(f, f), out(f),
             out(f, taps * ch), out(ch), out(ch))
    with torch.cuda.device(dev):
        err = lib.vgd_glow_flow_stack_bwd(
            *(t.data_ptr() for t in (xsave, an_b, an_s, wt, w1f, w1t, b1, w2,
                                     w2t, b2, wz, wzf, bz, scale, g)),
            *(t.data_ptr() for t in grads), scratch.data_ptr(), ints,
            _k6_stamps(stamps, plan.syncs(n_flows)[1], g), *dims,
            int(grid), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "glow_flow_stack_bwd")
    LAUNCHES["glow_flow_stack_bwd"] += 1
    return grads


def glow_flow_stack_sync_probe(n: int, device) -> None:
    """Launches K6's bf16 backward grid (its block size, shared memory and
    block count) through ``n`` grid syncs and nothing else: the cost of one
    sync, measured apart (``chip_smoke.py``). Counts no launch."""
    lib = _build.glow_flow_stack_lib()
    with torch.cuda.device(device):
        err = lib.vgd_glow_flow_stack_sync_probe(
            int(n), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "glow_flow_stack_sync_probe")
