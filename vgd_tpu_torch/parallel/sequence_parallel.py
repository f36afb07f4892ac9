"""Sequence parallelism: ring attention over the mesh's model axis
(``vgd_tpu/parallel/sequence_parallel.py``).

* q, k, v are token-sharded over the model group (p ranks): each rank holds
  N / p query rows and one K/V block;
* p hops: each rank attends its queries to the K/V block it holds, then
  passes the block to rank m + 1 and takes rank m - 1's (``ring_shift``;
  K and V travel as one tensor, one exchange a hop);
* the partial results merge by the online-softmax rescaling flash
  attention uses, carried in f32; each hop's products are stock PyTorch
  (``torch.einsum``), as the JAX body is an ``einsum`` and no Pallas
  kernel.

Gradients follow JAX's design, "the transpose of a ring shift is the
reverse ring shift": ``ring_shift``'s backward sends the gradient to m - 1
and takes m + 1's. Each shift is one paired ``batch_isend_irecv``, in the
same order on every rank, so forward and backward cannot deadlock. On gloo
(CPU tensors, or two ranks on one card) a CUDA tensor moves through host
memory explicitly.

Around the ring the UNet runs replicated over the model group, as under
JAX's jit, through two conjugate ops: ``split_tokens`` (forward: this
rank's tokens; backward: the token gradients all-gathered) and
``gather_tokens`` (forward: the output tokens all-gathered; backward: this
rank's slice). Without them the gradients upstream of the attention come
out partial or counted p times.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from vgd_tpu_torch.parallel.collectives import to_comm, gather, size


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``t`` to group rank m + step, return what m - step sent."""
    p = size(group)
    if p == 1:
        return t
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % p)
    src = dist.get_global_rank(group, (me - step) % p)
    send = to_comm(t.contiguous(), group)
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        req.wait()
    return recv.to(t.device)


class _RingShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """One hop of the ring (to m + 1, from m - 1); its gradient takes the
    reverse hop."""
    return _RingShift.apply(t, group)


def _token_bounds(n: int, group):
    p = size(group)
    if n % p:
        raise ValueError(f"{n} tokens do not split over the model axis "
                         f"({p})")
    m = dist.get_rank(group) if p > 1 else 0
    return m * (n // p), (m + 1) * (n // p)


def _all_tokens(t: torch.Tensor, group) -> torch.Tensor:
    return torch.cat(gather(t.contiguous(), group), dim=1)


class _SplitTokens(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        lo, hi = _token_bounds(x.shape[1], group)
        return x[:, lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_tokens(g, ctx.group), None


class _GatherTokens(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_tokens(x, group)

    @staticmethod
    def backward(ctx, g):
        lo, hi = _token_bounds(g.shape[1], ctx.group)
        return g[:, lo:hi].contiguous(), None


def split_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """(B, N, ...) replicated over the model group -> this rank's (B, N/p,
    ...); the backward all-gathers the token gradients."""
    return _SplitTokens.apply(x, group)


def gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """(B, N/p, ...) token shards -> (B, N, ...) on every rank; the
    backward takes this rank's slice."""
    return _GatherTokens.apply(x, group)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Per-rank ring attention body. q, k, v: (B, N/p, D), this rank's
    token shard of (B, N, D) arrays sharded over ``group`` (p ranks).
    Returns this rank's (B, N/p, D) rows of full attention."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    p = size(group)
    kv = torch.cat([k, v], dim=-1)
    acc = m = l = None
    for hop in range(p):
        kb, vb = kv.split(d, dim=-1)
        logits = torch.einsum("bnd,bmd->bnm", q.float(), kb.float()) * scale
        if m is None:
            m_new = logits.amax(dim=-1)
            pexp = torch.exp(logits - m_new[..., None])
            l = pexp.sum(dim=-1)
            acc = torch.einsum("bnm,bmd->bnd", pexp, vb.float())
        else:
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)          # rescale the old state
            pexp = torch.exp(logits - m_new[..., None])
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bnm,bmd->bnd", pexp, vb.float())
        m = m_new
        if hop < p - 1:
            kv = ring_shift(kv, group)
    return (acc / l[..., None]).to(q.dtype)


def sp_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention of (B, N, D) inputs replicated over ``group`` with
    the tokens sharded over it: split, the ring, gather. Returns (B, N, D)
    on every rank."""
    qkv = split_tokens(torch.cat([q, k, v], dim=-1), group)
    d = q.shape[-1]
    q, k, v = (t.contiguous() for t in qkv.split(d, dim=-1))
    return gather_tokens(ring_attention_local(q, k, v, group, scale), group)
