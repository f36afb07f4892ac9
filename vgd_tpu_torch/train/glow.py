"""Glow trainers on images and on EEG (``vgd_tpu/train/glow.py``,
``GlowTrainer`` and ``GlowEEGTrainer``).

Images: 5-bit quantisation plus U(0, 1/n_bins) dequantisation noise, a
first pass without gradient that performs the data-dependent ActNorm init
(after which Adam starts afresh), the bits/dim loss and Adam. EEG: the same
skeleton on float trials (B, T, 1, C) with U(0, 1) dequantisation noise and
the reference's loss normalisation, ``calc_loss(log_p, mean(logdet), T,
1.0, n_channels=3)`` (its image formula with n_pixel = T * T * 3), kept
verbatim. The noise comes from the caller (``noise``, a U(0, 1) draw of the
batch's shape) or from an explicit ``torch.Generator``; metrics stay 0-d
device tensors.

Under data parallelism (``mesh``) the trainer holds this rank's rows of
the global batch: the dequantisation noise is drawn for the global batch
and sliced (a given one is the global batch's too), the ActNorm init takes
the global batch's statistics, the gradients are averaged over the data
axis before the Adam step, and the losses come back as the global
batch's. ``GlowConfig.remat`` recomputes each flow in the backward.
A step is the span ``vgd.glow.step`` around ``vgd.glow.forward``,
``vgd.glow.backward`` and ``vgd.glow.adam``, and the ActNorm init
``vgd.glow.init`` (``utils/trace.py``).

A model axis (``mesh.model`` > 1) runs one of Glow's two model-parallel
modes over the model group, as in JAX: pipeline parallelism for images
when ``GlowConfig.pp_stages`` > 0 (every rank holds the full parameters and
its stage runs 1/p of each block's flows), otherwise tensor parallelism
(each rank holds its shard of the coupling filters). The gradient
reduction fits each leaf:

* pipeline: a flow leaf's gradient covers its stage's flows only, so it is
  summed over the model group, then averaged over the data axis; the
  replicated leaves (the priors) average over the whole world, because
  the replicas may differ by the card's atomics (``Mesh.grad_group``);
* tensor: a shard leaf averages over the data axis only, every replicated
  leaf (its gradient whole on every rank) over the world.

``load`` takes a full state (a checkpoint or a JAX state) and cuts this
rank's shard from it; ``checkpoint_state`` gives the full state back
(collective under tensor parallelism: every rank of the model group calls
it), so a checkpoint is the same file whatever the mesh.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from vgd_tpu_torch.core.config import GlowConfig, GlowEEGConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.models.glow import (Glow, calc_loss, calc_z_shapes,
                                       calc_z_shapes_eeg)
from vgd_tpu_torch.ops.image import quantize_bits, to_unit
from vgd_tpu_torch.parallel.collectives import average_grads
from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
from vgd_tpu_torch.parallel.pipeline_parallel import sum_stage_grads
from vgd_tpu_torch.parallel.tensor_parallel import (gather_glow_state,
                                                    shard_glow_state,
                                                    split_axis)
from vgd_tpu_torch.train.common import DTYPES, adam, batch_draw, mean_metrics
from vgd_tpu_torch.utils import trace


class _GlowTrainerBase:
    """The model, its Adam and the step on ``device``; a subclass calls
    ``_setup`` and sets ``z_shapes``, ``_prep`` (batch -> dequantised
    input) and ``_loss``."""

    model: Glow
    z_shapes: List[Tuple[int, int, int]]

    def _setup(self, cfg, device, mesh: Mesh, **model_kw) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        pp = getattr(cfg, "pp_stages", 0)
        # the model axis's consumer: "pp", "tp" or None (a trainer restored
        # in one process runs neither, as JAX's has no pp_mesh there)
        self.parallel = ("pp" if pp > 0 and mesh.model == pp else
                         "tp" if mesh.model > 1 else None)
        if self.parallel == "pp":
            model_kw.update(pp_group=mesh.model_group,
                            pp_microbatches=cfg.pp_microbatches)
        elif self.parallel == "tp":
            model_kw["tp_group"] = mesh.model_group
        with torch.device(self.device):
            self.model = Glow(n_flows=cfg.n_flows, n_blocks=cfg.n_blocks,
                              filter_size=cfg.filter_size,
                              compute_dtype=DTYPES[cfg.run.compute_dtype],
                              **model_kw)
        self.model.group = mesh.data_group
        self.opt: Optional[torch.optim.Optimizer] = None
        self.step = 0

    def _fresh_optimizer(self) -> None:
        # P and s_sign are buffers: Adam holds the trainable leaves only
        self.opt = adam(self.model.parameters(), self.cfg.lr)

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        self.model.init_parameters(generator)
        self._fresh_optimizer()
        self.step = 0

    def _names(self) -> List[str]:
        """The parameters' keys in Adam's order."""
        return [k for k, _ in self.model.named_parameters()]

    def load(self, params: Dict[str, torch.Tensor],
             opt_state: Optional[dict] = None, step: int = 0) -> None:
        """Load a full ``model.state_dict()`` (buffers included, strict)
        and, when given, the Adam state_dict; under tensor parallelism
        this rank's shard of them."""
        if self.parallel == "tp":
            params, opt_state = shard_glow_state(
                params, opt_state, self._names(), self.cfg.filter_size,
                self.mesh.m, self.mesh.model)
        self.model.load_state_dict(params, strict=True)
        self._fresh_optimizer()
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)
        self.step = int(step)

    def checkpoint_state(self) -> Tuple[Dict[str, torch.Tensor], dict]:
        """(the model's full state_dict, Adam's full state_dict): under
        tensor parallelism gathered from the model group in rank order
        (collective), else this trainer's own."""
        params, opt = self.model.state_dict(), self.opt.state_dict()
        if self.parallel == "tp":
            return gather_glow_state(params, self.mesh.model_group, opt,
                                     self._names())
        return params, opt

    def _reduce_grads(self) -> None:
        """Each leaf's gradient reduced over the ranks that share it (module
        docstring)."""
        mesh = self.mesh
        named = list(self.model.named_parameters())
        if self.parallel is None:
            average_grads([t for _, t in named], mesh.data_group)
        elif self.parallel == "pp":
            flows = [t for n, t in named if ".flows." in n]
            rest = [t for n, t in named if ".flows." not in n]
            sum_stage_grads(flows, mesh.model_group)
            average_grads(flows, mesh.data_group)
            average_grads(rest, mesh.grad_group)
        else:
            average_grads([t for n, t in named if split_axis(n) is not None],
                          mesh.data_group)
            average_grads([t for n, t in named if split_axis(n) is None],
                          mesh.grad_group)

    def _noise(self, x: torch.Tensor, generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor]) -> torch.Tensor:
        """This rank's rows of the U(0, 1) dequantisation draw for the
        global batch: ``noise`` or from ``generator``."""
        if noise is None:
            return batch_draw(self.mesh, lambda s: torch.rand(
                s, generator=generator, device=self.device), x.shape)
        return self.mesh.rows(noise).to(self.device, torch.float32)

    def init_step(self, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> None:
        """ActNorm's data-dependent init on this batch, then a fresh Adam."""
        with trace.timed("vgd.glow.init", "glow.init_s"):
            self.model.init_actnorm(self._prep(batch, generator, noise))
            self._fresh_optimizer()

    def train_step(self, batch: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One Adam step on the loss; returns loss, log_p and logdet (per
        dimension, in bits) as 0-d device tensors."""
        with trace.timed("vgd.glow.step", "glow.step_min_s", least=True):
            with trace.span("vgd.glow.forward"):
                x = self._prep(batch, generator, noise)
                log_p, logdet, _ = self.model(x)
                loss, lp, ld = self._loss(log_p, logdet)
            with trace.span("vgd.glow.backward"):
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                self._reduce_grads()
            with trace.span("vgd.glow.adam"):
                self.opt.step()
                self.opt.zero_grad(set_to_none=True)
            self.step += 1
            out = mean_metrics({"loss": loss.detach(), "log_p": lp.detach(),
                                "logdet": ld.detach()}, self.mesh)
        trace.COUNTERS["glow.steps"] += 1
        return out

    def reverse(self, z_list: List[torch.Tensor]) -> torch.Tensor:
        """z -> sample (under tensor parallelism every rank of the model
        group calls it)."""
        return self.model.reverse([z.to(self.device) for z in z_list])

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        """(log_p, logdet, z list) for likelihood evaluation; with
        ``flow_stack`` the blocks run K6's forward that saves nothing. Under
        a model axis every rank of the model group calls it."""
        return self.model(x.to(self.device))

    def sample_z(self, generator: Optional[torch.Generator], n: int,
                 temperature: Optional[float] = None) -> List[torch.Tensor]:
        """One z per block, standard normal times the temperature."""
        temp = self.cfg.temperature if temperature is None else temperature
        return [torch.randn((n,) + s, generator=generator,
                            device=self.device) * temp
                for s in self.z_shapes]


class GlowTrainer(_GlowTrainerBase):
    """Glow on square uint8 images (B, H, W, C)."""

    def __init__(self, cfg: GlowConfig, img_shape: Tuple[int, int, int],
                 device="cuda", mesh: Mesh = LOCAL):
        h, w, c = img_shape
        if h != w:
            raise ValueError(f"square images expected, got {h}x{w}")
        self._setup(cfg, device, mesh, in_channels=c, variant="image",
                    fused_coupling=cfg.fused_coupling,
                    flow_stack=cfg.flow_stack, remat=cfg.remat)
        self.img_shape = tuple(img_shape)
        self.n_bins = 2.0 ** cfg.n_bits
        self.z_shapes = calc_z_shapes(c, h, cfg.n_blocks)

    def _prep(self, batch_uint8: torch.Tensor,
              generator: Optional[torch.Generator],
              noise: Optional[torch.Tensor]) -> torch.Tensor:
        """n-bit quantisation + U(0, 1/n_bins) dequantisation noise."""
        x = quantize_bits(to_unit(batch_uint8.to(self.device)),
                          self.cfg.n_bits)
        return x + self._noise(x, generator, noise) / self.n_bins

    def _loss(self, log_p, logdet):
        return calc_loss(log_p, logdet.mean(), self.img_shape[0],
                         self.n_bins, n_channels=self.img_shape[2])


class GlowEEGTrainer(_GlowTrainerBase):
    """The 1-D Glow on float EEG trials (B, T, 1, C): (3, 1) convs, time
    squeezes, f32 by default; never a kernel (the JAX trainer sets neither
    ``fused_coupling`` nor ``flow_stack``)."""

    def __init__(self, cfg: GlowEEGConfig, device="cuda",
                 mesh: Mesh = LOCAL):
        self._setup(cfg, device, mesh, in_channels=cfg.num_channels,
                    variant="eeg")
        self.z_shapes = calc_z_shapes_eeg(cfg.num_channels, cfg.num_samples,
                                          cfg.n_blocks)

    def _prep(self, batch: torch.Tensor,
              generator: Optional[torch.Generator],
              noise: Optional[torch.Tensor]) -> torch.Tensor:
        """batch + U(0, 1) dequantisation noise."""
        x = batch.to(self.device, torch.float32)
        return x + self._noise(x, generator, noise)

    def _loss(self, log_p, logdet):
        # the reference's normalisation, verbatim: calc_loss with T as the
        # image size, n_bins 1 and 3 channels
        return calc_loss(log_p, logdet.mean(), self.cfg.num_samples, 1.0,
                         n_channels=3)
