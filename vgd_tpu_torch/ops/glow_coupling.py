"""The fused Glow coupling network (``vgd_tpu/ops/glow_coupling.py``):
Conv(kh x kw, -> f) -> ReLU -> Conv1x1(f) -> ReLU -> ZeroConv (value-1
padding, x exp(3 scale)), as one differentiable op on K5.

* ``prep`` casts the input and packs the model's HWIO weights into the
  layouts K5 reads (``ops/kernels.py``, section K5);
* ``_GlowCoupling`` is the custom VJP of the JAX package: the forward saves
  only (ya, weights); the backward recomputes h1 and h2 in K5's backward 1,
  which also gives the ZeroConv's gradients and dh2 (h1 and dh2 in the
  compute dtype), then backward 2 gives the conv2 / conv1 gradients and dya;
  the packed weight gradients go back to the model's layout.

The math is the fused kernel's, not the stock chain's: bf16 operands with
f32 sums, h1 and h2 rounded to the compute dtype, the ZeroConv weights in
the compute dtype too (the stock chain runs the ZeroConv in f32). On a CUDA
tensor every call launches K5 or raises; on the CPU, and inside
``kernels.plain_reference()``, the same function runs the plain versions.
The forward goes through the registered op ``vgd::glow_coupling_fwd``, so a
traced Glow reverse (``io/export.py``) records the op and not its plain
arithmetic.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from vgd_tpu_torch.ops import kernels as K


def _operand(t: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``t`` in ``cd``, contiguous. No data pointer is read here, so the
    forward traces under ``torch.export``; the forward op and the backward
    align their operands (``kernels.aligned16``)."""
    return t.to(cd).contiguous()


def prep(ya: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
         wz: torch.Tensor, cd: torch.dtype) -> Dict[str, torch.Tensor]:
    """ya (B, H, W, cin) and the HWIO weights w1 (kh, kw, cin, f), w2
    (1, 1, f, f), wz (kh, kw, f, cout) -> K5's operands in ``cd``: ya, w1f
    (taps*cin, f), w1t (taps*f, cin), w2 (f, f), w2t, wz (taps*f, cout),
    wzf (taps*cout, f)."""
    kh, kw, cin, f = w1.shape
    cout = wz.shape[-1]
    taps = kh * kw
    w2c = w2.reshape(f, f)
    return {"ya": _operand(ya, cd),
            "w1f": _operand(w1.reshape(taps * cin, f), cd),
            "w1t": _operand(w1.permute(0, 1, 3, 2).reshape(taps * f, cin),
                            cd),
            "w2": _operand(w2c, cd), "w2t": _operand(w2c.t(), cd),
            "wz": _operand(wz.reshape(taps * f, cout), cd),
            "wzf": _operand(wz.permute(0, 1, 3, 2).reshape(taps * cout, f),
                            cd)}


class _GlowCoupling(torch.autograd.Function):

    @staticmethod
    def forward(ctx, ya, w1, b1, w2, b2, wz, bz, scale, khw, pad, cd):
        p = prep(ya, w1, w2, wz, cd)
        out = K.glow_coupling_fwd(p["ya"], p["w1f"], b1.float(), p["w2"],
                                  b2.float(), p["wz"], bz.float(),
                                  scale.float(), khw, pad, wzf=p["wzf"])
        ctx.save_for_backward(ya, w1, b1, w2, b2, wz, bz, scale)
        ctx.conf = (khw, pad, cd)
        return out

    @staticmethod
    def backward(ctx, g):
        ya, w1, b1, w2, b2, wz, bz, scale = ctx.saved_tensors
        khw, pad, cd = ctx.conf
        p = {k: K.aligned16(t) for k, t in prep(ya, w1, w2, wz, cd).items()}
        h1, dh2, dwz, dbz, db2, dscale = K.glow_coupling_bwd1(
            p["ya"], p["w1f"], b1.float(), p["w2"], b2.float(), p["wz"],
            p["wzf"], bz.float(), scale.float(),
            K.aligned16(_operand(g, torch.float32)), khw, pad)
        dya, dw1, db1, dw2 = K.glow_coupling_bwd2(
            p["ya"], p["w1t"], p["w2t"], h1, dh2, khw, pad, w1f=p["w1f"])
        kh, kw, f, cout = wz.shape
        dwz = dwz.reshape(f, kh, kw, cout).permute(1, 2, 0, 3)
        return (dya.to(ya.dtype), dw1.reshape(w1.shape).to(w1.dtype),
                db1.to(b1.dtype), dw2.reshape(w2.shape).to(w2.dtype),
                db2.to(b2.dtype), dwz.to(wz.dtype), dbz.to(bz.dtype),
                dscale.to(scale.dtype), None, None, None)


def glow_coupling_nn(p: Dict[str, Dict[str, torch.Tensor]], ya: torch.Tensor,
                     khw: Tuple[int, int], pad: Tuple[int, int],
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """NN(ya) in f32 (to be added to yb). ``p`` = {"conv1": {w, b},
    "conv2": {w, b}, "zero": {w, b, scale}} with HWIO weights; ``pad`` the
    (ph, pw) of the "same" conv; ``compute_dtype`` the operand dtype of the
    products (their sums are f32)."""
    return _GlowCoupling.apply(
        ya, p["conv1"]["w"], p["conv1"]["b"], p["conv2"]["w"],
        p["conv2"]["b"], p["zero"]["w"], p["zero"]["b"], p["zero"]["scale"],
        tuple(khw), tuple(pad), compute_dtype)
