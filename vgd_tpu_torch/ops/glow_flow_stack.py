"""The Glow flow stack of one block as one kernel per chunk and direction
(``vgd_tpu/ops/glow_flow_stack.py``): K flows of ActNorm -> invertible 1x1
conv -> additive coupling on K6.

* ``_pack`` casts the stacked HWIO conv weights of a chunk's flows to the
  compute dtype and packs them into K6's per-flow rows (``ops/kernels.py``,
  section K6), one op per leaf and layout for the whole chunk;
* ``_FlowStack`` is the custom VJP of the JAX package: its forward runs the
  kernel that saves each flow's input, its backward the kernel that walks
  the flows in reverse from those inputs; the packed weight gradients go
  back to the model's stacked layouts;
* a call that needs no gradient (grad mode off, or no input that requires
  one) runs the forward that saves nothing.

The math is K6's, not the per-flow path's: the 1x1 conv takes cd operands
(with f32 sums) and the gradient is rounded to cd on every flow. The PLU
weight is assembled by the caller (``wt_all``, transposed), so its gradient
reaches L, U and log_s through ordinary autograd, and the logdet is the
caller's too. On a CUDA tensor every call launches K6 or raises; on the
CPU, and inside ``kernels.plain_reference()``, the plain versions run.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vgd_tpu_torch.ops import kernels as K


def _rows(t: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """(G, ...) -> (G, k6_stride(n)) in ``cd``, each flow's n values first."""
    g = t.shape[0]
    t = t.reshape(g, -1).to(cd)
    n = t.shape[1]
    return F.pad(t, (0, K.k6_stride(n) - n)).contiguous()


def _pack(w1: torch.Tensor, w2: torch.Tensor, wz: torch.Tensor,
          cd: torch.dtype, backward: bool) -> Dict[str, torch.Tensor]:
    """Stacked HWIO w1 (G, kh, kw, ch, f), w2 (G, 1, 1, f, f), wz (G, kh, kw,
    f, ch) -> K6's packed w1f, w2, wz and, for the backward, w1t, w2t, wzf
    (K5's per-flow layouts, ``ops/glow_coupling.prep``)."""
    g, f = w2.shape[0], w2.shape[-1]
    p = {"w1f": _rows(w1, cd), "w2": _rows(w2, cd), "wz": _rows(wz, cd)}
    if backward:
        p.update(w1t=_rows(w1.permute(0, 1, 2, 4, 3), cd),
                 w2t=_rows(w2.reshape(g, f, f).transpose(1, 2), cd),
                 wzf=_rows(wz.permute(0, 1, 2, 4, 3), cd))
    return p


def _vectors(an_b, an_s, wt, b1, b2, bz, scale):
    return tuple(t.float().contiguous() for t in (an_b, an_s, wt, b1, b2, bz,
                                                  scale))


def _forward(x, an_b, an_s, wt, w1, b1, w2, b2, wz, bz, scale, khw, pad, cd,
             save: bool):
    p = _pack(w1, w2, wz, cd, backward=False)
    an_b, an_s, wt, b1, b2, bz, scale = _vectors(an_b, an_s, wt, b1, b2, bz,
                                                 scale)
    return K.glow_flow_stack_fwd(x.float().contiguous(), an_b, an_s, wt,
                                 p["w1f"], b1, p["w2"], b2, p["wz"], bz,
                                 scale, khw, pad, save)


class _FlowStack(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, an_b, an_s, wt, w1, b1, w2, b2, wz, bz, scale, khw,
                pad, cd):
        y, xsave = _forward(x, an_b, an_s, wt, w1, b1, w2, b2, wz, bz, scale,
                            khw, pad, cd, save=True)
        ctx.save_for_backward(xsave, an_b, an_s, wt, w1, b1, w2, b2, wz, bz,
                              scale)
        ctx.conf = (khw, pad, cd)
        return y

    @staticmethod
    def backward(ctx, g):
        xsave, an_b, an_s, wt, w1, b1, w2, b2, wz, bz, scale = \
            ctx.saved_tensors
        khw, pad, cd = ctx.conf
        p = _pack(w1, w2, wz, cd, backward=True)
        vb, vs, vwt, vb1, vb2, vbz, vsc = _vectors(an_b, an_s, wt, b1, b2, bz,
                                                   scale)
        (dx, danb, dans, dwt, dw1, db1, dw2, db2, dwz, dbz,
         dscale) = K.glow_flow_stack_bwd(
            xsave, vb, vs, vwt, p["w1f"], p["w1t"], vb1, p["w2"], p["w2t"],
            vb2, p["wz"], p["wzf"], vbz, vsc, g.float().contiguous(), khw,
            pad)
        n, kh, kw, f, ch = wz.shape
        dwz = dwz.reshape(n, f, kh, kw, ch).permute(0, 2, 3, 1, 4)
        return (dx, danb.to(an_b.dtype), dans.to(an_s.dtype),
                dwt.to(wt.dtype), dw1.reshape(w1.shape).to(w1.dtype),
                db1.to(b1.dtype), dw2.reshape(w2.shape).to(w2.dtype),
                db2.to(b2.dtype), dwz.to(wz.dtype), dbz.to(bz.dtype),
                dscale.to(scale.dtype), None, None, None)


def glow_flow_stack(flows: Dict, wt_all: torch.Tensor, x: torch.Tensor,
                    khw: Tuple[int, int], pad: Tuple[int, int],
                    compute_dtype: torch.dtype = torch.bfloat16,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """Run all K flows of one block on x (B, H, W, c); returns y f32.

    ``flows``: the block's stacked flow leaves ({"actnorm": {b, s},
    "coupling": {"conv1": {w, b}, "conv2": {w, b}, "zero": {w, b, scale}}},
    leading K, HWIO kernels). ``wt_all`` (K, c, c): the TRANSPOSED PLU
    weights, assembled by the caller. Flows run in chunks of ``chunk``
    (default K: one launch per block and direction), chained through the
    f32 activation; the chunk size does not change the math."""
    n_flows = wt_all.shape[0]
    g = chunk or n_flows
    an, cpl = flows["actnorm"], flows["coupling"]
    leaves = (an["b"], an["s"], wt_all, cpl["conv1"]["w"], cpl["conv1"]["b"],
              cpl["conv2"]["w"], cpl["conv2"]["b"], cpl["zero"]["w"],
              cpl["zero"]["b"], cpl["zero"]["scale"])
    conf = (tuple(khw), tuple(pad), compute_dtype)
    y = x.float()
    for s in range(0, n_flows, g):
        args = (y, *(t[s:s + g] for t in leaves), *conf)
        # the decision is made here: inside Function.forward grad is off
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in args[:len(leaves) + 1]):
            y = _FlowStack.apply(*args)
        else:
            y = _forward(*args, save=False)
    return y
