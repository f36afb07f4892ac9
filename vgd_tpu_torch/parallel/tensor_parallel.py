"""Tensor parallelism over the mesh's model axis: Glow's coupling filters
sharded over the model group (``vgd_tpu/parallel/tensor_parallel.py``).

JAX places the coupling leaves with a ``NamedSharding`` and lets jit's
sharding propagation insert the collectives. The port holds this rank's
shard of each split leaf as the parameter itself and runs the coupling
network with explicit collectives, one ``torch.autograd.Function`` each:

=========  ==========================================  =====================
pass       step                                        collective
=========  ==========================================  =====================
forward    ``conv1`` on this rank's f/p filters, ReLU,
           ``conv2``'s partial product over its f/p
           input filters (f32 sums)                    --
forward    the partial products of ``conv2``           reduce-scatter over
                                                       the filters: this
                                                       rank's f/p slice,
                                                       then its slice of
                                                       ``conv2.b``, ReLU
forward    the ZeroConv's partial product over that    all-reduce of the
           slice                                       c-wide output, then
                                                       ``zero.b`` and
                                                       ``exp(3 scale)``
backward   reduce-scatter                              all-gather
backward   the gradient of the coupling input ``ya``   all-reduce
=========  ==========================================  =====================

Every sum over ranks adds in rank order (``collectives.gather``, or each
rank summing the chunks ``all_to_all_single`` hands it in rank order), so
every replicated result is the same bits on every rank of the group. The
layers between the couplings, the priors and the loss run replicated.
``conv2.b`` is replicated: each rank adds its slice, and its gradient comes
back whole on every rank (``_ShardOf``'s backward all-gathers it), so a
replicated leaf's gradient is the whole one on every rank.

* ``coupling_param_specs``: the split axis of each coupling leaf in the
  stacked HWIO layout (``None``: replicated); ``split_axis`` of a
  state-dict key;
* ``shard_glow_coupling`` / ``shard_glow_state``: a full state (parameters
  and Adam's moments) sliced to this rank's shard;
* ``gather_glow_state``: the inverse, collective over the model group (the
  full tensors in rank order, for checkpoints);
* ``tp_coupling_nn``: the sharded coupling network.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vgd_tpu_torch.parallel.collectives import all_sum, gather, size, to_comm


def coupling_param_specs() -> Dict[str, Dict[str, Optional[int]]]:
    """The axis of each stacked coupling leaf (K, kh, kw, cin, cout) split
    over the model axis; None = replicated."""
    return {
        # hidden filters split on conv1's output axis ...
        "conv1": {"w": 4, "b": 1},
        # ... conv2's input axis (its output is reduce-scattered)
        "conv2": {"w": 3, "b": None},
        # ... and the ZeroConv's input axis (its output all-reduced)
        "zero": {"w": 3, "b": None, "scale": None},
    }


def split_axis(name: str) -> Optional[int]:
    """The split axis of the state-dict key ``name``
    (``block0.flows.coupling.conv1.w`` -> 4), None for a replicated leaf."""
    parts = name.split(".")
    if "coupling" not in parts[:-2]:
        return None
    return coupling_param_specs().get(parts[-2], {}).get(parts[-1])


def check_filters(filter_size: int, p: int) -> None:
    """JAX's refusal of a model axis that does not divide the filters."""
    if filter_size % p != 0:
        raise ValueError(
            f"filter_size {filter_size} not divisible by the model axis "
            f"({p} devices) — choose --mesh-model dividing the coupling "
            f"filter count")


def _shard(t: torch.Tensor, axis: int, m: int, p: int) -> torch.Tensor:
    n = t.shape[axis] // p
    return t.narrow(axis, m * n, n).clone()


def shard_glow_coupling(params: Dict[str, torch.Tensor], m: int, p: int
                        ) -> Dict[str, torch.Tensor]:
    """A full Glow state_dict with every split leaf cut to rank ``m``'s
    shard of ``p`` (the rest as given)."""
    return {k: t if split_axis(k) is None or p == 1
            else _shard(t, split_axis(k), m, p) for k, t in params.items()}


def _map_adam(opt_state: dict, names: Sequence[str], fn) -> dict:
    """An Adam state_dict with ``fn(name, moment)`` applied to both moments
    of every parameter (``names``: the parameters' keys in the optimizer's
    order)."""
    state = {}
    for i, st in opt_state["state"].items():
        st = dict(st)
        for key in ("exp_avg", "exp_avg_sq"):
            st[key] = fn(names[int(i)], st[key])
        state[i] = st
    return {**opt_state, "state": state}


def shard_glow_state(params: Dict[str, torch.Tensor],
                     opt_state: Optional[dict], names: Sequence[str],
                     filter_size: int, m: int, p: int
                     ) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """A full state (parameters, and Adam's state_dict over ``names``) cut
    to rank ``m``'s shard of ``p``; raises JAX's error when ``p`` does not
    divide ``filter_size``."""
    check_filters(filter_size, p)
    params = shard_glow_coupling(params, m, p)
    if opt_state is not None and p > 1:
        opt_state = _map_adam(opt_state, names, lambda k, t: t if split_axis(
            k) is None else _shard(t, split_axis(k), m, p))
    return params, opt_state


def _gather_split(tensors: List[Tuple[torch.Tensor, int]], group
                  ) -> List[torch.Tensor]:
    """Each (shard, axis) rebuilt whole from every rank's shard, in rank
    order, with one all-gather for all of them."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).float() for t, _ in tensors])
    parts = gather(flat, group)
    out, off = [], 0
    for t, axis in tensors:
        n = t.numel()
        out.append(torch.cat([q[off:off + n].view(t.shape).to(t.dtype)
                              for q in parts], dim=axis))
        off += n
    return out


def gather_glow_state(params: Dict[str, torch.Tensor], group,
                      opt_state: Optional[dict] = None,
                      names: Optional[Sequence[str]] = None
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """The full state from every rank's shard (collective: every rank of
    the model group calls it): split leaves and their Adam moments
    concatenated in rank order, the rest this rank's own."""
    if size(group) == 1:
        return params, opt_state
    keys = [k for k in params if split_axis(k) is not None]
    items = [(params[k], split_axis(k)) for k in keys]
    moments = []
    if opt_state is not None:
        for i, st in opt_state["state"].items():
            k = names[int(i)]
            if split_axis(k) is not None:
                for key in ("exp_avg", "exp_avg_sq"):
                    moments.append((i, key))
                    items.append((st[key], split_axis(k)))
    whole = _gather_split(items, group)
    full = dict(params)
    full.update(zip(keys, whole[:len(keys)]))
    if opt_state is not None:
        state = {i: dict(st) for i, st in opt_state["state"].items()}
        for (i, key), t in zip(moments, whole[len(keys):]):
            state[i][key] = t
        opt_state = {**opt_state, "state": state}
    return full, opt_state


# ---------------------------------------------------------- the collectives
def _rank(group) -> int:
    return dist.get_rank(group) if size(group) > 1 else 0


def _all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last axis, in rank order."""
    return torch.cat(gather(t.contiguous(), group), dim=-1)


def _slice_last(t: torch.Tensor, group) -> torch.Tensor:
    n = t.shape[-1] // size(group)
    m = _rank(group)
    return t[..., m * n:(m + 1) * n].contiguous()


def reduce_scatter_last(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice (of p along the last axis) of the sum of every
    rank's ``t``: each rank sends slice r to rank r (``all_to_all_single``)
    and adds what it receives in rank order."""
    p = size(group)
    if p == 1:
        return t
    n = t.shape[-1] // p
    chunks = t.reshape(-1, p, n).transpose(0, 1).contiguous()
    send = to_comm(chunks, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(t.device)
    total = recv[0]
    for r in range(1, p):
        total = total + recv[r]
    return total.reshape(t.shape[:-1] + (n,))


class _CopyToModel(torch.autograd.Function):
    """Forward: the replicated input as is; backward: the gradients of the
    ranks' shards summed (each rank's covers its own filters only)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g.contiguous(), ctx.group), None


class _SumFromModel(torch.autograd.Function):
    """Forward: the partial products summed in rank order, the same bits on
    every rank; backward: the replicated gradient as is."""

    @staticmethod
    def forward(ctx, t, group):
        return all_sum(t.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    """Forward: this rank's filter slice of the summed partial products;
    backward: the slices' gradients all-gathered."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return reduce_scatter_last(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group), None


class _ShardOf(torch.autograd.Function):
    """Forward: this rank's slice of a replicated tensor's last axis;
    backward: the slices' gradients all-gathered (the whole gradient on
    every rank)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _slice_last(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group), None


def tp_coupling_nn(glow, p: Dict[str, Dict[str, torch.Tensor]],
                   xa: torch.Tensor, group) -> torch.Tensor:
    """The coupling network of ``glow`` (NHWC ``xa``, replicated) with this
    rank's shard ``p`` of the filters: the stock chain's function, conv1
    and conv2 in the compute dtype with their partial sums in f32, the
    ZeroConv in f32. Returns NN(xa) in f32 on every rank."""
    cd = glow.compute_dtype
    xa = _CopyToModel.apply(xa, group)
    h = torch.relu(glow._conv(p["conv1"], xa, glow.pad, cd))
    # the f32 product of compute-dtype operands: what a conv in the
    # compute dtype sums before it rounds its output
    w2 = p["conv2"]["w"].to(cd).float()
    part = F.conv2d(h.float().permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1))
    s = _ReduceScatter.apply(part.permute(0, 2, 3, 1), group)
    h = torch.relu(s.to(cd) + _ShardOf.apply(p["conv2"]["b"], group).to(cd))
    z = p["zero"]
    ph, pw = glow.pad
    hz = F.pad(h.float(), (0, 0, pw, pw, ph, ph), value=1.0)
    part = F.conv2d(hz.permute(0, 3, 1, 2), z["w"].float().permute(3, 2, 0, 1))
    out = _SumFromModel.apply(part.permute(0, 2, 3, 1), group)
    return (out + z["b"].float()) * torch.exp(z["scale"] * 3.0)
