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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from vgd_tpu_torch.core.config import GlowConfig, GlowEEGConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.models.glow import (Glow, calc_loss, calc_z_shapes,
                                       calc_z_shapes_eeg)
from vgd_tpu_torch.ops.image import quantize_bits, to_unit
from vgd_tpu_torch.train.common import DTYPES, adam


class _GlowTrainerBase:
    """The model, its Adam and the step on ``device``; a subclass calls
    ``_setup`` and sets ``z_shapes``, ``_prep`` (batch -> dequantised
    input) and ``_loss``."""

    model: Glow
    z_shapes: List[Tuple[int, int, int]]

    def _setup(self, cfg, device, **model_kw) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = Glow(n_flows=cfg.n_flows, n_blocks=cfg.n_blocks,
                              filter_size=cfg.filter_size,
                              compute_dtype=DTYPES[cfg.run.compute_dtype],
                              **model_kw)
        self.opt: Optional[torch.optim.Optimizer] = None
        self.step = 0

    def _fresh_optimizer(self) -> None:
        # P and s_sign are buffers: Adam holds the trainable leaves only
        self.opt = adam(self.model.parameters(), self.cfg.lr)

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        self.model.init_parameters(generator)
        self._fresh_optimizer()
        self.step = 0

    def load(self, params: Dict[str, torch.Tensor],
             opt_state: Optional[dict] = None, step: int = 0) -> None:
        """Load a ``model.state_dict()`` (buffers included, strict) and,
        when given, the Adam state_dict."""
        self.model.load_state_dict(params, strict=True)
        self._fresh_optimizer()
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)
        self.step = int(step)

    def _noise(self, x: torch.Tensor, generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor]) -> torch.Tensor:
        """The U(0, 1) dequantisation draw: ``noise`` or from
        ``generator``."""
        if noise is None:
            return torch.rand(x.shape, generator=generator,
                              device=self.device)
        return noise.to(self.device, torch.float32)

    def init_step(self, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> None:
        """ActNorm's data-dependent init on this batch, then a fresh Adam."""
        self.model.init_actnorm(self._prep(batch, generator, noise))
        self._fresh_optimizer()

    def train_step(self, batch: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One Adam step on the loss; returns loss, log_p and logdet (per
        dimension, in bits) as 0-d device tensors."""
        x = self._prep(batch, generator, noise)
        log_p, logdet, _ = self.model(x)
        loss, lp, ld = self._loss(log_p, logdet)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1
        return {"loss": loss.detach(), "log_p": lp.detach(),
                "logdet": ld.detach()}

    def reverse(self, z_list: List[torch.Tensor]) -> torch.Tensor:
        """z -> sample."""
        return self.model.reverse([z.to(self.device) for z in z_list])

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        """(log_p, logdet, z list) for likelihood evaluation; with
        ``flow_stack`` the blocks run K6's forward that saves nothing."""
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
                 device="cuda"):
        h, w, c = img_shape
        if h != w:
            raise ValueError(f"square images expected, got {h}x{w}")
        self._setup(cfg, device, in_channels=c, variant="image",
                    fused_coupling=cfg.fused_coupling,
                    flow_stack=cfg.flow_stack)
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

    def __init__(self, cfg: GlowEEGConfig, device="cuda"):
        self._setup(cfg, device, in_channels=cfg.num_channels,
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
