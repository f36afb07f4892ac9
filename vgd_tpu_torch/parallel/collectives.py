"""Collectives over one axis of the mesh, in an order every rank shares.

* ``gather``: the group's tensors, in rank order.
* ``all_sum`` / ``all_mean``: their sum / mean, in rank order, so every
  rank computes the same bits (a floating all-reduce may add in another
  order on each rank); ``AllMean`` is the mean's differentiable form,
  whose backward is ``all_mean`` of the gradient (the adjoint of a mean
  that every rank's loss reads, under gradients averaged over the ranks
  afterwards).
* ``merge_moments``: per-channel (mean, biased variance) of equal shards
  merged into the whole batch's by Chan's formula, in rank order.
* ``average_grads``: the ``.grad`` of every parameter all-reduced in
  buckets and divided by the group's size, before an optimizer step.
* ``broadcast_``: tensors overwritten with rank 0's, in place.

A gloo group has no CUDA send / recv, so on a gloo group a CUDA tensor
goes through host memory explicitly. With no group (one process) every
function is the identity; a group of one process still runs its
collective (an exact copy).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# elements of one all-reduce bucket (128 MB of f32)
BUCKET_ELEMS = 1 << 25


def staged(group) -> bool:
    """Whether ``group`` moves CUDA tensors through host memory (gloo)."""
    return group is not None and dist.get_backend(group) == "gloo"


def to_comm(t: torch.Tensor, group) -> torch.Tensor:
    return t.cpu() if t.is_cuda and staged(group) else t


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape everywhere), in rank order."""
    if group is None:
        return [t]
    src = to_comm(t.detach().contiguous(), group)
    out = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``, in rank order."""
    if group is None:
        return t
    parts = gather(t, group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def all_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's ``t``, summed in rank order."""
    return t if group is None else all_sum(t, group) / size(group)


class AllMean(torch.autograd.Function):
    """``all_mean`` under autograd; its backward is ``all_mean`` of the
    gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_mean(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_mean(g.contiguous(), ctx.group), None


def merge_moments(mean: torch.Tensor, var: torch.Tensor, count: int, group
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole batch's (mean, biased var) from every rank's over
    ``count`` elements each: Chan's pairwise update, rank 0 first."""
    if group is None:
        return mean, var
    parts = gather(torch.stack([mean, var]), group)
    m, v = parts[0][0], parts[0][1]
    n = float(count)
    for p in parts[1:]:
        tot = n + count
        delta = p[0] - m
        m = m + delta * (count / tot)
        v = (v * n + p[1] * count + delta * delta * (n * count / tot)) / tot
        n = tot
    return m, v


def _buckets(tensors: Sequence[torch.Tensor]):
    """Runs of tensors of one dtype and device, each under BUCKET_ELEMS
    elements (a larger tensor alone)."""
    run, elems = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or elems + t.numel() > BUCKET_ELEMS):
            yield run
            run, elems = [], 0
        run.append(t)
        elems += t.numel()
    if run:
        yield run


def _flat_collective(tensors: Sequence[torch.Tensor], group, op) -> None:
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        comm = to_comm(flat, group)
        op(comm)
        if comm is not flat:
            flat.copy_(comm)
        off = 0
        for t in run:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def average_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Every parameter's ``.grad`` replaced by its mean over the group
    (parameters without a gradient are left out on every rank alike)."""
    if group is None:
        return
    n = size(group)

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)
    _flat_collective([p.grad for p in params if p.grad is not None], group,
                     reduce)


def broadcast_(tensors: Iterable[torch.Tensor], group=None,
               src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s over ``group`` (default:
    the whole world when a process group is started)."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return
        group = dist.group.WORLD
    with torch.no_grad():
        _flat_collective([t for t in tensors], group,
                         lambda flat: dist.broadcast(flat, src,
                                                     group=group))


def barrier(group: Optional[object] = None) -> None:
    """Wait for every rank (no-op without a process group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)
