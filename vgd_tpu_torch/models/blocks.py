"""BatchNorm with Flax's semantics (``flax.linen.BatchNorm`` as the VAE-GAN
networks use it, and ``vgd_tpu/models/blocks.py`` ``BNParams`` on the fused
path).

Stock ``nn.BatchNorm2d`` differs in ways that change the numbers, so the
port keeps its own:

* running stats follow ``ra = m * ra + (1 - m) * batch`` with m = 0.9
  (torch's momentum 0.1);
* the running variance takes the *biased* batch variance (torch's update
  takes the unbiased one);
* statistics, normalisation and the affine transform run in f32 whatever
  the input dtype; the batch variance is Flax's E[x^2] - E[x]^2 clamped at
  0, computed in f32;
* the module can run in train mode without touching its running stats
  (``frozen_running_stats``): the VAE-GAN step's discriminator-phase
  forward of the encoder and decoder throws those updates away;
* under data parallelism (``group``, the mesh's data group) the batch
  statistics are the global batch's, as under JAX's sharded-batch jit:
  every rank's per-channel mean of x and of x^2 (Flax's two statistics)
  are averaged in rank order (``parallel.collectives.AllMean``, the same
  bits on every rank), and the backward averages their gradients over the
  ranks. ``torch.nn.SyncBatchNorm`` is no substitute: its running variance
  is the unbiased one.

Parameter and buffer names map onto the Flax tree one to one: ``scale`` ->
``weight``, ``bias`` -> ``bias``, ``batch_stats`` ``mean`` / ``var`` ->
``running_mean`` / ``running_var``. Train or eval is an argument of
``forward``, as ``use_running_average`` is in Flax, not the module's
``training`` flag.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch import nn

from vgd_tpu_torch.parallel.collectives import AllMean

F32 = torch.float32
_DIMS = (0, 1, 2)          # NHWC: statistics over batch and space


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of NHWC input; returns f32."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum, self.eps = momentum, eps
        self.update_stats = True
        # the data-parallel group whose global batch the statistics cover
        self.group = None

    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Flax's momentum update of the running stats with batch (mean,
        biased var), unless frozen."""
        if not self.update_stats:
            return
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var.detach())

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=_DIMS)
            mean2 = torch.square(xf).mean(dim=_DIMS)
            if self.group is not None:
                mean, mean2 = AllMean.apply(torch.stack([mean, mean2]),
                                            self.group)
            var = torch.clamp(mean2 - torch.square(mean), min=0.0)
            self.update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def set_group(group, *modules: nn.Module) -> None:
    """Every ``BatchNorm`` of ``modules`` takes its batch statistics over
    ``group``'s global batch (None: this process's batch)."""
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, BatchNorm):
                m.group = group


@contextlib.contextmanager
def frozen_running_stats(*modules: nn.Module) -> Iterator[None]:
    """Inside the block no ``BatchNorm`` of ``modules`` updates its running
    stats (train-mode forwards still normalise with batch statistics)."""
    bns = [m for mod in modules for m in mod.modules()
           if isinstance(m, BatchNorm)]
    before = [bn.update_stats for bn in bns]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn, b in zip(bns, before):
            bn.update_stats = b
