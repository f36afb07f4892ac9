"""Loss and optimizer primitives (``vgd_tpu/train/common.py``), and the
data-parallel pieces every trainer shares: draws made for the global batch
and sliced (``batch_draw``), and metrics reported as the global batch's
(``mean_metrics``).

``scan_epoch`` has no counterpart: it is a compiled ``lax.scan`` over an
epoch, and the port loops over steps in Python.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator, Sequence

import torch
import torch.nn.functional as F

from vgd_tpu_torch.parallel.collectives import all_mean
from vgd_tpu_torch.parallel.mesh import Mesh

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mse(a: torch.Tensor, b: torch.Tensor,
        reduction: str = "mean") -> torch.Tensor:
    """Squared error in f32, mean or sum over every element."""
    d = torch.square(a.float() - b.float())
    return d.mean() if reduction == "mean" else d.sum()


def bce(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities: ``torch.nn.BCELoss`` itself,
    the reference's loss. Mean over elements, both log terms clamped at
    -100 (the forward of the JAX package's ``bce``). Its backward stays
    finite where the f32 sigmoid saturates to exactly 0 or 1 (a confident
    discriminator at 256x256); the JAX function's gradient is 0/0 there."""
    p = p.float()
    return F.binary_cross_entropy(p, target.to(p.dtype).expand_as(p))


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """``optax.adam`` as a torch optimizer: both keep bias-corrected first
    and second moments and add eps outside the square root, so the update
    is the same (up to f32 rounding order)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


@torch.no_grad()
def clamp_params(module: torch.nn.Module, clip_value: float) -> None:
    """WGAN weight clipping: every ``nn.Parameter`` of ``module`` clamped to
    [-clip_value, clip_value] in place (BatchNorm's scale and shift too;
    its running statistics are buffers and stay as they are)."""
    for p in module.parameters():
        p.clamp_(-clip_value, clip_value)


@contextlib.contextmanager
def frozen_parameters(module: torch.nn.Module) -> Iterator[None]:
    """Forwards inside the block record no gradient for ``module``'s
    parameters (a G step's discriminator: its input gradient still flows,
    and no weight gradient is computed at all)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def batch_draw(mesh: Mesh, make: Callable[[tuple], torch.Tensor],
               shape: Sequence[int], axis: int = 0):
    """This rank's rows of ``make(global shape)``: a draw for the global
    batch, whose size is ``shape[axis]`` (this rank's rows) times the data
    axis. Every rank draws the same from its generator, which stays in
    step with a one-process run's; ``make`` may return a tuple of draws
    (``CorruptDraws``)."""
    glob = list(shape)
    glob[axis] *= mesh.data
    return mesh.rows(make(tuple(glob)), axis)


def mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over ``mesh.grad_group`` in one collective (a
    rank's loss estimates the global batch's, so their mean is the global
    one)."""
    if mesh.grad_group is None:
        return metrics
    vals = all_mean(torch.stack([metrics[k].detach().float()
                                 for k in metrics]), mesh.grad_group)
    return dict(zip(metrics, vals.unbind(0)))
