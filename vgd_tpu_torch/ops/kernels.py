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
* ``groupnorm_silu`` (K4, serving) -> the Triton kernels in
  ``ops/groupnorm_silu_triton.py``;
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

Each wrapper takes its plain version only for a tensor that lies on the CPU
(the tests); for a CUDA tensor it launches the kernel or raises. There is
no fallback; the one size gate is ``attention``'s, the JAX package's, which
sends small attentions to the plain form before any wrapper is called.
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


# Attentions with N * M below this take the plain full-matrix form: the JAX
# package's MIN_FLASH_ELEMS. Kept because on the H100 K2 under autograd
# (forward, delta, dq, dk/dv) measured slower than the plain form at the
# UNet's cross_attn3, N * M = 2^18 (PERF.md, Findings).
MIN_FLASH_ELEMS = 1 << 20


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable softmax(q k^T scale) v, the counterpart of
    ``attention`` in ``vgd_tpu/ops/pallas_kernels.py``. q (B, N, D), k/v
    (B, M, D). As there, N * M below ``MIN_FLASH_ELEMS`` takes the plain
    full-matrix attention (differentiated by autograd, no launch); every
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
    """convz (B*H*W, cout) = conv of h2 padded with the value 1, + bz."""
    b, h, w = shape
    h2p = _pad_hw(h2.reshape(b, h, w, -1), pad[0], pad[1], 1.0)
    return _mm(_im2col(h2p, h, w, *khw), wz) + bz


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


def glow_coupling_fwd(ya, w1f, b1, w2, b2, wz, bz, scale, khw, pad
                      ) -> torch.Tensor:
    """K5 forward: NN(ya) (B, H, W, cout) f32. On CUDA every operand is
    contiguous, the weights in ya's dtype (bf16 or f32), in the packed
    layouts above; ragged sizes are masked in the kernel."""
    if _on_cpu(ya, w1f, b1, w2, b2, wz, bz, scale):
        return glow_coupling_fwd_plain(ya, w1f, b1, w2, b2, wz, bz, scale,
                                       khw, pad)
    cd, f32 = ya.dtype, torch.float32
    taps = khw[0] * khw[1]
    f, cout = w2.shape[0], bz.shape[0]
    cin = ya.shape[-1]
    dims = _k5_geometry("glow_coupling_fwd", ya, f, cout, khw, pad, [
        ("ya", ya, tuple(ya.shape), cd), ("w1f", w1f, (taps * cin, f), cd),
        ("b1", b1, (f,), f32), ("w2", w2, (f, f), cd), ("b2", b2, (f,), f32),
        ("wz", wz, (taps * f, cout), cd), ("bz", bz, (cout,), f32),
        ("scale", scale, (cout,), f32)])
    b, h, w = dims[:3]
    dev = ya.device
    out = torch.empty((b, h, w, cout), dtype=f32, device=dev)
    h1 = torch.empty((b * h * w, f), dtype=cd, device=dev)
    h2 = torch.empty_like(h1)
    lib = _build.glow_coupling_lib()
    part = _k5_part(lib, dims, dev)
    with torch.cuda.device(dev):
        err = lib.vgd_glow_coupling_fwd(
            *(t.data_ptr() for t in (ya, w1f, b1, w2, b2, wz, bz, scale, out,
                                     h1, h2, part)),
            *dims, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "glow_coupling_fwd")
    LAUNCHES["glow_coupling_fwd"] += 1
    return out


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
    gs = torch.empty((b * h * w, cout), dtype=cd, device=dev)
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


def glow_coupling_bwd2(ya, w1t, w2t, h1, dh2, khw, pad):
    """K5 backward 2: (dya (B, H, W, cin), dw1 (kh*kw*cin, f), db1 (f,),
    dw2 (f, f)) f32, from backward 1's h1 and dh2."""
    if _on_cpu(ya, w1t, w2t, h1, dh2):
        return glow_coupling_bwd2_plain(ya, w1t, w2t, h1, dh2, khw, pad)
    cd, f32 = ya.dtype, torch.float32
    taps = khw[0] * khw[1]
    b, h, w, cin = ya.shape
    f = w2t.shape[0]
    # backward 2 never reads the ZeroConv's width: cout 1 stands for it
    dims = _k5_geometry("glow_coupling_bwd2", ya, f, 1, khw, pad, [
        ("ya", ya, tuple(ya.shape), cd), ("w1t", w1t, (taps * f, cin), cd),
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
            *(t.data_ptr() for t in (ya, w1t, w2t, h1, dh2, dya, dw1, db1,
                                     dw2, dh1, part)),
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


def _k6_scratch(lib, dims, backward, dev) -> torch.Tensor:
    n = lib.vgd_glow_flow_stack_scratch_bytes(*dims[1:], int(backward))
    _require(n > 0, f"K6: shape {dims[1:10]} not supported")
    return torch.empty((n,), dtype=torch.uint8, device=dev)


def glow_flow_stack_fwd(x, an_b, an_s, wt, w1f, b1, w2, b2, wz, bz, scale,
                        khw, pad, save: bool):
    """K6 forward: y (B, H, W, c) f32, and with ``save`` also xsave (G, B,
    H, W, c) f32. One launch for the G flows; on CUDA every operand is
    contiguous, the packed weights in cd (bf16 or f32)."""
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
    lib = _build.glow_flow_stack_lib()
    scratch = _k6_scratch(lib, dims, False, dev)
    y = torch.empty_like(x)
    xsave = (torch.empty((n_flows,) + tuple(x.shape), dtype=torch.float32,
                         device=dev) if save else None)
    with torch.cuda.device(dev):
        err = lib.vgd_glow_flow_stack_fwd(
            *(t.data_ptr() for t in (x, an_b, an_s, wt, w1f, b1, w2, b2, wz,
                                     bz, scale, y)),
            None if xsave is None else xsave.data_ptr(), scratch.data_ptr(),
            *dims, int(save), torch.cuda.current_stream(dev).cuda_stream)
    name = "glow_flow_stack_fwd" if save else "glow_flow_stack_fwd_nosave"
    _raise_on(lib, err, name)
    LAUNCHES[name] += 1
    return (y, xsave) if save else y


def glow_flow_stack_bwd(xsave, an_b, an_s, wt, w1f, w1t, b1, w2, w2t, b2, wz,
                        wzf, bz, scale, g, khw, pad):
    """K6 backward: the gradients of ``glow_flow_stack_bwd_plain``, one
    launch for the G flows. g (B, H, W, c) f32."""
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
    lib = _build.glow_flow_stack_lib()
    scratch = _k6_scratch(lib, dims, True, dev)

    def out(*shape):
        return torch.empty((n_flows,) + shape, dtype=f32, device=dev)
    grads = (torch.empty_like(g), out(c), out(c), out(c, c),
             out(taps * ch, f), out(f), out(f, f), out(f),
             out(f, taps * ch), out(ch), out(ch))
    with torch.cuda.device(dev):
        err = lib.vgd_glow_flow_stack_bwd(
            *(t.data_ptr() for t in (xsave, an_b, an_s, wt, w1f, w1t, b1, w2,
                                     w2t, b2, wz, wzf, bz, scale, g)),
            *(t.data_ptr() for t in grads), scratch.data_ptr(), *dims,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "glow_flow_stack_bwd")
    LAUNCHES["glow_flow_stack_bwd"] += 1
    return grads
