"""Pipeline parallelism: a Glow block's flow chain as a GPipe pipeline over
the mesh's model axis (``vgd_tpu/parallel/pipeline_parallel.py``).

* Stage m of p (the model group's rank m) runs flows [m K/p, (m+1) K/p)
  of a block; every rank holds the full parameters and slices its flows.
* The batch is split into M microbatches that stream through the stages on
  the ``M + p - 1``-tick schedule: at tick t stage m runs microbatch t - m.
  Activations hop stage to stage with ``sequence_parallel``'s ring shift
  (JAX's ``ppermute`` ring); every rank takes part in every hop, and a
  stage with no microbatch at a tick (the bubble) sends zeros and computes
  nothing (the SPMD JAX body computes on zeros there; the result is the
  same).
* The last stage's outputs reach every rank of the group by a broadcast,
  JAX's masked ``psum``.

Gradients: JAX differentiates through ``scan`` + ``ppermute``. Autograd
would run the hops' backwards in an order of its own on each rank, and a
hop whose result feeds nothing (a bubble's) would never run, so the ranks'
sends and receives would not pair. So ``_Pipeline`` keeps each
microbatch's stage graph from the forward and runs the backward on the
reverse schedule itself: at reverse tick t stage m takes microbatch t - m,
with the output cotangent from stage m + 1's reverse hop (the last stage
uses the cotangent of the broadcast output: every rank computes the same
downstream loss, and the last stage takes it once, not p times), and
``torch.autograd.grad`` gives the stage input's gradient (the reverse hop
to stage m - 1) and its flows' parameter gradients, summed over the
microbatches. Stage 0's input gradients reach every rank by a broadcast.
No forward is recomputed: with ``fused_coupling`` a stage launches K5's
forward, backward 1 and backward 2 once per flow and microbatch.

A stage's parameter gradients cover its own flows only (the flow logdet is
data-independent and computed outside the pipeline; ``owned`` lets its
gradient through for this stage's flows only), so the flows' gradients
are the sum over the model group (``sum_stage_grads``), and a trainer then
averages them over the data axis.

* ``pipeline_flows_local``: the per-stage body;
* ``pp_flow_stack``: JAX's global-shape wrapper, with its asserts;
* ``pp_train_step``: the single-block loss, its gradient through the
  pipeline, then Adam.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from vgd_tpu_torch.parallel.collectives import gather, size, to_comm
from vgd_tpu_torch.parallel.sequence_parallel import _shift

# the stage body's leaves, in the order ``_Pipeline`` takes them
_PATHS = (("actnorm", "b"), ("actnorm", "s"), ("w",),
          ("coupling", "conv1", "w"), ("coupling", "conv1", "b"),
          ("coupling", "conv2", "w"), ("coupling", "conv2", "b"),
          ("coupling", "zero", "w"), ("coupling", "zero", "b"),
          ("coupling", "zero", "scale"))


def stage_of(group) -> Tuple[int, int]:
    """(this rank's stage, the stage count) of the model group."""
    p = size(group)
    return (dist.get_rank(group) if p > 1 else 0), p


def stage_bounds(k: int, group) -> Tuple[int, int]:
    """[lo, hi) of the flows this rank's stage runs."""
    m, p = stage_of(group)
    return m * k // p, (m + 1) * k // p


def owned(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (stacked over K) with its gradient let through for this
    stage's flows only; the same values on every rank."""
    if size(group) == 1:
        return t
    lo, hi = stage_bounds(t.shape[0], group)
    return torch.cat([t[:lo].detach(), t[lo:hi], t[hi:].detach()])


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree(leaves: Sequence[torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, t in zip(_PATHS, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _broadcast(t: torch.Tensor, group, member: int) -> torch.Tensor:
    """Group rank ``member``'s ``t`` on every rank of the group."""
    if size(group) == 1:
        return t
    comm = to_comm(t.contiguous(), group)
    dist.broadcast(comm, dist.get_global_rank(group, member), group=group)
    return comm.to(t.device)


def _stage(glow, leaves: Sequence[torch.Tensor], a: torch.Tensor, hw: int
           ) -> torch.Tensor:
    """This stage's flows, in order, on one microbatch."""
    per = [t.unbind(0) for t in leaves]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for k in range(len(per[0])):
        p = _tree([t[k] for t in per])
        a, _, _ = glow._flow_fwd(p, a, hw, False, p["w"], zero)
    return a


def _forward(glow, leaves, x_mb, group, graphs=None) -> torch.Tensor:
    """The forward schedule. With ``graphs`` (a list) each microbatch's
    (stage input, stage output) is kept with its autograd graph, the input
    a leaf that requires a gradient unless this is stage 0 and ``x_mb``
    needs none."""
    m, p = stage_of(group)
    n_mb = x_mb.shape[0]
    hw = x_mb.shape[2] * x_mb.shape[3]
    ys = torch.zeros_like(x_mb) if m == p - 1 else None
    recv = None
    for t in range(n_mb + p - 1):
        j = t - m
        send = None
        if 0 <= j < n_mb:
            a = x_mb[j] if m == 0 else recv
            if graphs is None:
                y = _stage(glow, leaves, a, hw)
            else:
                a = a.detach().requires_grad_(m > 0 or x_mb.requires_grad)
                with torch.enable_grad():
                    y = _stage(glow, leaves, a, hw)
                graphs.append((a, y))
            send = y.detach()
            if m == p - 1:
                ys[j] = send
        # the last tick's hop would feed no stage
        if t < n_mb + p - 2:
            recv = _shift(send if send is not None
                          else torch.zeros_like(x_mb[0]), group, 1)
    return _broadcast(ys if ys is not None else torch.empty_like(x_mb),
                      group, p - 1)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, glow, group, x_mb, *leaves):
        ctx.group = group
        ctx.graphs = []
        ctx.leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in leaves]
        ctx.x_shape = x_mb.shape
        x_in = x_mb.detach().requires_grad_(ctx.needs_input_grad[2])
        return _forward(glow, ctx.leaves, x_in, group, ctx.graphs)

    @staticmethod
    def backward(ctx, g_ys):
        group = ctx.group
        m, p = stage_of(group)
        n_mb = ctx.x_shape[0]
        want = [t for t in ctx.leaves if t.requires_grad]
        grads = [None] * len(want)
        dx = (torch.zeros(ctx.x_shape, dtype=g_ys.dtype, device=g_ys.device)
              if ctx.needs_input_grad[2] else None)
        recv = None
        for t in reversed(range(n_mb + p - 1)):
            j = t - m
            send = None
            if 0 <= j < n_mb:
                a, y = ctx.graphs[j]
                g = g_ys[j] if m == p - 1 else recv
                inputs = ([a] if a.requires_grad else []) + want
                got = torch.autograd.grad(y, inputs, g, allow_unused=True)
                ctx.graphs[j] = None
                if a.requires_grad:
                    send, got = got[0], got[1:]
                    if m == 0:
                        dx[j] = send
                grads = [d if s is None else (s if d is None else s + d)
                         for s, d in zip(grads, got)]
            # the hop of reverse tick 0 would feed no stage
            if t > 0:
                recv = _shift(send if send is not None
                              else torch.zeros(ctx.x_shape[1:],
                                               dtype=g_ys.dtype,
                                               device=g_ys.device), group, -1)
        if dx is not None:
            dx = _broadcast(dx, group, 0)
        it = iter(grads)
        leaf_grads = [next(it) if t.requires_grad else None
                      for t in ctx.leaves]
        ctx.graphs = ctx.leaves = None
        return (None, None, dx, *leaf_grads)


def pipeline_flows_local(glow, local_flows: Dict, x_mb: torch.Tensor, group
                         ) -> torch.Tensor:
    """Per-stage GPipe body. ``local_flows``: this stage's stacked flow
    leaves (leading dim K/p): ``actnorm`` {b, s}, ``w`` (the PLU weights)
    and ``coupling``. ``x_mb``: (M, Bm, H, W, C) microbatches, the same on
    every rank. Returns the last stage's (M, Bm, H, W, C) on every rank."""
    leaves = [_leaf(local_flows, path) for path in _PATHS]
    if torch.is_grad_enabled() and (x_mb.requires_grad or any(
            t.requires_grad for t in leaves)):
        return _Pipeline.apply(glow, group, x_mb, *leaves)
    with torch.no_grad():
        return _forward(glow, leaves, x_mb, group)


def flow_logdets(flows: Dict, hw: int) -> torch.Tensor:
    """(K,) ActNorm + 1x1-conv logdet of each flow at ``hw`` positions."""
    return hw * (torch.sum(torch.log(torch.abs(flows["actnorm"]["s"])), dim=1)
                 + torch.sum(flows["invconv"]["log_s"], dim=1))


def pp_flow_stack(glow, flows: Dict, x: torch.Tensor, n_microbatches: int,
                  group, w_all: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-shape wrapper: this rank's stage of the stacked ``flows``
    ({actnorm, invconv, coupling}, leading dim K), ``x`` (B, H, W, C) split
    into ``n_microbatches``, the pipeline; returns (y (B, H, W, C), logdet
    (n_microbatches,)) on every rank. ``w_all``: the K PLU weights when
    already computed. The logdet is data-independent: each microbatch's is
    the stack's sum (its gradient through this stage's flows only)."""
    b = x.shape[0]
    assert b % n_microbatches == 0, (b, n_microbatches)
    k = flows["actnorm"]["b"].shape[0]
    p = size(group)
    assert k % p == 0, (
        f"flow count K={k} must divide evenly over the {p}-way model axis "
        f"(each pipeline stage scans K/p flows); got K % p == {k % p}")
    if w_all is None:
        w_all = glow._plu_weight(SimpleNamespace(**flows["invconv"]))
    lo, hi = stage_bounds(k, group)
    local = {"actnorm": {n: t[lo:hi] for n, t in flows["actnorm"].items()},
             "w": w_all[lo:hi],
             "coupling": {c: {n: t[lo:hi] for n, t in leaves.items()}
                          for c, leaves in flows["coupling"].items()}}
    x_mb = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    ys = pipeline_flows_local(glow, local, x_mb, group)
    ld = torch.sum(owned(flow_logdets(flows, x.shape[1] * x.shape[2]), group))
    return ys.reshape(x.shape), ld.expand(n_microbatches)


def sum_stage_grads(params: Sequence[torch.Tensor], group) -> None:
    """The ``.grad`` of every stacked flow leaf (leading dim K) replaced by
    its sum over the model group: each stage's rows [lo, hi) come from the
    stage that owns them (every other stage's are zero there), with one
    all-gather, in place."""
    p = size(group)
    if p == 1:
        return
    grads = [t.grad for t in params if t.grad is not None]
    if not grads:
        return
    lo, hi = stage_bounds(grads[0].shape[0], group)
    parts = gather(torch.cat([g[lo:hi].reshape(-1) for g in grads]), group)
    with torch.no_grad():
        for r, part in enumerate(parts):
            off = 0
            for g in grads:
                k = g.shape[0]
                rows = g[r * k // p:(r + 1) * k // p]
                rows.copy_(part[off:off + rows.numel()].view_as(rows))
                off += rows.numel()


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"actnorm.b": t, ...} -> {"actnorm": {"b": t}, ...}."""
    tree: Dict = {}
    for name, t in flat.items():
        node, (*head, last) = tree, name.split(".")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def pp_train_step(glow, flows: Dict[str, torch.Tensor], opt, x: torch.Tensor,
                  n_microbatches: int, group) -> torch.Tensor:
    """One pipeline-parallel training step over a block's flow stack:
    ``flows`` maps "actnorm.b" style names to the stacked leaves (leaves of
    ``opt``, a torch optimizer; the invconv's P and s_sign included, they
    get no gradient); the loss is the standard-normal NLL of the pipelined
    output minus the mean logdet, its gradient summed over the stages,
    then ``opt.step()``. Returns the loss."""
    y, ld = pp_flow_stack(glow, nest(flows), x, n_microbatches, group)
    log_p = (-0.5 * torch.sum(torch.square(y), dim=(1, 2, 3))
             - 0.5 * math.log(2 * math.pi) * y[0].numel())
    loss = -(torch.mean(log_p) + torch.mean(ld))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    sum_stage_grads([t for t in flows.values() if t.requires_grad], group)
    opt.step()
    return loss.detach()

