"""The port's kernels and their plain PyTorch versions.

Counterpart of ``vgd_tpu/ops/pallas_kernels.py`` and of the kernel of
``vgd_tpu/ops/fused_conv.py``, for the kernels on the DDPM and VAE-GAN paths:

* ``attention`` (K2, training: forward with logsumexp, dq, dk/dv) -> the
  CUDA kernels in ``csrc/flash_attention.cu`` (forward) and
  ``csrc/flash_attention_bwd.cu`` (backward), bound as a
  ``torch.autograd.Function``;
* ``flash_attention`` (K3, serving) -> the CUDA kernel in
  ``csrc/flash_attention.cu``;
* ``groupnorm_silu`` (K4, serving) -> the Triton kernels in
  ``ops/groupnorm_silu_triton.py``;
* ``conv_stats`` (K1, VAE-GAN training: Conv4x4 stride 2 with the
  per-channel batch statistics of its output) -> the CUDA kernels in
  ``csrc/conv_bn_stats.cu``; ``ops/fused_conv.py`` builds the
  differentiable Conv + BatchNorm + LeakyReLU on it.

Each wrapper takes its plain version only for a tensor that lies on the CPU
(the tests); for a CUDA tensor it launches the kernel or raises. There is
no size gate and no fallback. ``LAUNCHES`` counts the wrapper calls that
launched a kernel, so a run can show that its main path went through them.

``plain_reference()`` is a context manager that routes every wrapper to its
plain version on any device. It exists so that ``chip_smoke.py`` and the
tests can run the same model on the card with no kernel at all, as the
reference the kernels are held against; nothing in the package enters it.
"""
from __future__ import annotations

import collections
import contextlib
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from vgd_tpu_torch.ops import _build, groupnorm_silu_triton

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


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (or inside ``plain_reference``),
    False when every one is on a CUDA device; raises on a mix or another
    device."""
    types = {t.device.type for t in tensors}
    if _PLAIN_REFERENCE and types <= {"cpu", "cuda"}:
        return True
    if types == {"cpu"}:
        return True
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA "
                     f"device, got {[str(t.device) for t in tensors]}")


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
    """softmax(q k^T * scale) v. On CUDA: f32, contiguous, head dim in
    ``FLASH_HEAD_DIMS``; ragged N and M are masked inside the kernel."""
    if _on_cpu(q, k, v):
        return attention_plain(q, k, v, scale)
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
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


_BQ = 64            # q rows per tile of the backward kernels
_BK = 32            # keys per tile


def dkv_splits(b: int, n: int, m: int, sm_count: int) -> Tuple[int, int]:
    """(splits, rows_per_split) of the q rows for the dk/dv kernel: one
    split while there are at least two (batch, key tile) blocks per SM,
    else about four blocks per SM, in whole 64-row tiles, so the 64-key
    cross-attentions (two key tiles per image) still fill the card."""
    q_tiles = -(-n // _BQ)
    blocks = b * -(-m // _BK)
    splits = 1 if blocks >= 2 * sm_count else \
        min(q_tiles, -(-4 * sm_count // blocks))
    tiles_per_split = -(-q_tiles // splits)
    return -(-q_tiles // tiles_per_split), tiles_per_split * _BQ


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable softmax(q k^T scale) v, the counterpart of
    ``attention`` in ``vgd_tpu/ops/pallas_kernels.py``. q (B, N, D), k/v
    (B, M, D). Unlike the TPU dispatch there is no size gate: the JAX
    package sends N * M < 2^20 to XLA because a Pallas call cost more than
    it saved there, a launch-overhead heuristic of the TPU; every call on
    CUDA runs the K2 kernels. Inside ``plain_reference()`` it is the plain
    full-matrix attention, differentiated by autograd."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    if _PLAIN_REFERENCE:
        return attention_plain(q, k, v, scale)
    return _Attention.apply(q, k, v, scale)


# ---------------------------------------------------------------------------
# K4: GroupNorm + SiLU
# ---------------------------------------------------------------------------

def groupnorm_silu_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int = 8,
                         eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (H, W, C/G) then SiLU, NHWC, two-pass f32 variance
    (the math of ``groupnorm_silu_xla``)."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).float()
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = xn * scale + bias
    return (y * torch.sigmoid(y)).to(x.dtype)


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Fused GroupNorm(groups) + SiLU. x (B, H, W, C); on CUDA x, scale and
    bias are f32 and contiguous, and C is a multiple of ``groups``."""
    if _on_cpu(x, scale, bias):
        return groupnorm_silu_plain(x, scale, bias, groups, eps)
    _require(x.ndim == 4, "groupnorm_silu takes x (B, H, W, C)")
    c = x.shape[-1]
    _require(c % groups == 0, f"channels {c} not a multiple of {groups}")
    _require(scale.shape == (c,) and bias.shape == (c,),
             f"scale/bias must have shape ({c},)")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    with torch.cuda.device(x.device):
        y = groupnorm_silu_triton.launch(x, scale, bias, groups, eps)
    LAUNCHES["groupnorm_silu"] += 1
    return y


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


def conv_stats(x: torch.Tensor, w: torch.Tensor, padding: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: (c (B, Ho, Wo, K) f32, mean (K,), biased var (K,)) of the stride-2
    4x4 conv of x (B, H, W, Cin) with w (K, Cin, 4, 4), padding 0 or 1,
    accumulated in f32. On CUDA: x contiguous NHWC, bf16 or f32, w of the
    same dtype in any layout (the wrapper flattens it to the (16 Cin, K)
    rows the kernel reads); odd and ragged sizes are masked in the kernel.
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
    wt = w.permute(2, 3, 1, 0).reshape(16 * cin, k).contiguous()
    lib = _build.conv_bn_stats_lib()
    tiles = lib.vgd_conv_stats_row_tiles(b, ho, wo)
    dev = x.device
    c = torch.empty((b, ho, wo, k), dtype=torch.float32, device=dev)
    part = torch.empty((2, k, tiles), dtype=torch.float32, device=dev)
    mean = torch.empty((k,), dtype=torch.float32, device=dev)
    var = torch.empty((k,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vgd_conv_bn_stats(
            x.data_ptr(), wt.data_ptr(), c.data_ptr(), part.data_ptr(),
            mean.data_ptr(), var.data_ptr(), b, h, wd, cin, k, padding,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "conv_bn_stats")
    LAUNCHES["conv_bn_stats"] += 1
    return c, mean, var
