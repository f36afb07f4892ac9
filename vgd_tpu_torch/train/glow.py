"""Glow trainer on images (``vgd_tpu/train/glow.py``, ``GlowTrainer``).

5-bit quantisation plus U(0, 1/n_bins) dequantisation noise, a first pass
without gradient that performs the data-dependent ActNorm init (after which
Adam starts afresh), the bits/dim loss and Adam. The noise comes from the
caller (``noise``, a U(0, 1) draw of the batch's shape) or from an explicit
``torch.Generator``; metrics stay 0-d device tensors. The EEG trainer waits
for the EEG slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from vgd_tpu_torch.core.config import GlowConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.models.glow import Glow, calc_loss, calc_z_shapes
from vgd_tpu_torch.ops.image import quantize_bits, to_unit
from vgd_tpu_torch.train.common import DTYPES, adam


class GlowTrainer:
    """The model, its Adam and the step on ``device``."""

    def __init__(self, cfg: GlowConfig, img_shape: Tuple[int, int, int],
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        h, w, c = img_shape
        if h != w:
            raise ValueError(f"square images expected, got {h}x{w}")
        self.img_shape = tuple(img_shape)
        with torch.device(self.device):
            self.model = Glow(in_channels=c, n_flows=cfg.n_flows,
                              n_blocks=cfg.n_blocks, variant="image",
                              filter_size=cfg.filter_size,
                              compute_dtype=DTYPES[cfg.run.compute_dtype],
                              fused_coupling=cfg.fused_coupling,
                              flow_stack=cfg.flow_stack)
        self.n_bins = 2.0 ** cfg.n_bits
        self.z_shapes = calc_z_shapes(c, h, cfg.n_blocks)
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

    def _prep(self, batch_uint8: torch.Tensor,
              generator: Optional[torch.Generator],
              noise: Optional[torch.Tensor]) -> torch.Tensor:
        """n-bit quantisation + U(0, 1/n_bins) dequantisation noise."""
        x = quantize_bits(to_unit(batch_uint8.to(self.device)),
                          self.cfg.n_bits)
        if noise is None:
            noise = torch.rand(x.shape, generator=generator,
                               device=self.device)
        return x + noise.to(self.device, torch.float32) / self.n_bins

    def init_step(self, batch_uint8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> None:
        """ActNorm's data-dependent init on this batch, then a fresh Adam."""
        self.model.init_actnorm(self._prep(batch_uint8, generator, noise))
        self._fresh_optimizer()

    def train_step(self, batch_uint8: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One Adam step on the bits/dim loss; returns loss, log_p and
        logdet (per dimension, in bits) as 0-d device tensors."""
        x = self._prep(batch_uint8, generator, noise)
        log_p, logdet, _ = self.model(x)
        loss, lp, ld = calc_loss(log_p, logdet.mean(), self.img_shape[0],
                                 self.n_bins, n_channels=self.img_shape[2])
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1
        return {"loss": loss.detach(), "log_p": lp.detach(),
                "logdet": ld.detach()}

    def reverse(self, z_list: List[torch.Tensor]) -> torch.Tensor:
        """z -> sample (images in [-0.5, 0.5] up to the flow's error)."""
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
