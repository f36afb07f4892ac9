"""The (data, model) process mesh (``vgd_tpu/parallel/mesh.py``).

JAX lays its mesh over ``jax.devices()``; the port runs one process per
card and lays the mesh over the processes of the ``torch.distributed``
world, in JAX's ``reshape(data, model)`` order: rank = d * model + m. A
``Mesh`` holds this rank's coordinates, the process group of its data axis
(the ranks that share m) and of its model axis (the ranks that share d),
and the shard bounds of a global batch. ``grad_group`` is the group over
which gradients and reported losses are averaged: the data axis, or the
whole world when a model axis replicates work (the ranks of one model
group compute the same gradients, equal up to the card's atomics, which
would otherwise let their parameters drift apart).

* ``shard_batch`` becomes ``Mesh.rows``: rows [d B / D, (d + 1) B / D) of
  the global batch, which every rank stages in full from the same seeded
  loader, as the JAX multihost loop does.
* ``shard_tree_replicated`` becomes ``collectives.broadcast_`` from rank 0
  at start-up.

A group is None where its axis needs no collective: no process group at
all, or an axis of size 1 other than the data axis of a started world (a
world of one process keeps its data group, so its collectives run).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh of processes."""
    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None
    world_group: Optional[Any] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def d(self) -> int:
        """This rank's coordinate on the data axis."""
        return self.rank // self.model

    @property
    def m(self) -> int:
        """This rank's coordinate on the model axis."""
        return self.rank % self.model

    @property
    def primary(self) -> bool:
        """Rank 0: the one process that writes files."""
        return self.rank == 0

    @property
    def grad_group(self):
        """Where gradients and losses are averaged (module docstring)."""
        return self.data_group if self.model == 1 else self.world_group

    def bounds(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of a global batch of ``n``."""
        if n % self.data:
            raise ValueError(f"batch {n} is not divisible by the data axis "
                             f"({self.data})")
        per = n // self.data
        return self.d * per, (self.d + 1) * per

    def rows(self, x, axis: int = 0):
        """This rank's rows (along the batch ``axis``) of a global batch:
        an array, a tensor, or a tuple / NamedTuple of them."""
        if isinstance(x, tuple):
            parts = [self.rows(t, axis) for t in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        lo, hi = self.bounds(x.shape[axis])
        return x[(slice(None),) * axis + (slice(lo, hi),)]

    def valid_rows(self, n_valid: int, n: int) -> int:
        """How many of this rank's rows of a global batch of ``n`` lie
        among its first ``n_valid`` (the true rows of a padded batch)."""
        lo, hi = self.bounds(n)
        return max(0, min(n_valid, hi) - lo)


# one process, no collective: what a trainer runs with when given no mesh
LOCAL = Mesh()


def resolve(data: int, model: int, n: int) -> Tuple[int, int]:
    """(data, model) of a mesh over ``n`` processes: ``data=-1`` takes
    every process the model axis leaves; the mesh must cover them all."""
    if model <= 0:
        model = 1
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    return data, model


def build_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the started world (one process when
    ``torch.distributed`` is not started); ``data=-1`` takes every process
    the model axis leaves. Every rank must call it, in the same order as
    any other group it makes."""
    started = dist.is_available() and dist.is_initialized()
    data, model = resolve(data, model,
                          dist.get_world_size() if started else 1)
    if not started:
        return Mesh(data, model)
    rank = dist.get_rank()
    world = dist.group.WORLD
    data_group = model_group = None
    if model == 1:
        data_group = world
    elif data == 1:
        model_group = world
    else:
        # every rank makes every group, in one order
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
    return Mesh(data, model, rank, data_group, model_group, world)
