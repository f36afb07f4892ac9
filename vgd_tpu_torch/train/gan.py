"""DCGAN and WGAN trainers (``vgd_tpu/train/gan.py``).

Two networks (``models.gan.Generator`` and ``Discriminator``), two Adams at
``cfg.lr`` with betas (beta1, beta2) = (0.5, 0.999).

DCGAN, one step (``train_step``):

1. fake = G(z) in train mode with no gradient; G's running stats of this
   forward are thrown away (``frozen_running_stats``), as the JAX step
   drops them;
2. one D step: bce(D(x), 1) + bce(D(fake), 0), each D forward in train
   mode advancing D's running stats (real, then fake);
3. one G step with the same z: bce(D(G(z)), 1) through the updated D. G's
   forward keeps its running stats; D's forward advances D's a third time
   and that is kept. D gets no Adam step and keeps no ``.grad``.

WGAN, one step (``train_step_wgan``): ``critic_iters`` critic steps, each
on a fresh z with G in train mode (G's running stats kept every time): D
loss mean(D(fake)) - mean(D(x)) (real forward first), an Adam step, then
every D parameter clamped to +-``clip_value`` (``clamp_params``: BN scale
and shift too, not the running stats); then a G step on one more z with
loss -mean(D(G(z))), D's stats advanced once more as in DCGAN. The
reference keeps the sigmoid on the critic; so does this port.

``train_step`` and ``train_step_wgan`` (its critic steps and their
in-place clips) can be captured as a CUDA graph (the epoch scan,
``common.StepGraph``); the Adams are ``capturable`` on a card.

z comes from the caller (DCGAN (B, latent); WGAN (critic_iters + 1, B,
latent)) or from an explicit ``torch.Generator``. Metrics (d_loss, the last
critic step's under WGAN, and g_loss) stay 0-d device tensors.

``cfg.run.fused_conv`` runs the discriminator's train-mode stages i > 0
through K1; ``generate`` never does.

Under data parallelism (``mesh``) the trainer holds this rank's rows of
the global batch: z is drawn for the global batch and sliced (a given z is
the global batch's too), the BatchNorms take the global batch's
statistics, the gradients are averaged over the data axis before every
Adam step (each critic step's and the G step's; the clip follows on the
same parameters on every rank), and the losses come back as the global
batch's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vgd_tpu_torch.core.config import GANConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.models.blocks import frozen_running_stats, set_group
from vgd_tpu_torch.models.gan import Discriminator, Generator
from vgd_tpu_torch.models.vae import latent_to_spatial
from vgd_tpu_torch.ops.image import to_signed
from vgd_tpu_torch.parallel.collectives import average_grads
from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
from vgd_tpu_torch.train.common import (DTYPES, adam, batch_draw,
                                         bce, clamp_params, frozen_parameters,
                                         mean_metrics)

NETS = ("gen", "disc")


class GANTrainer:
    """Generator, discriminator, their two Adams and the steps on
    ``device``."""

    def __init__(self, cfg: GANConfig, img_shape: Tuple[int, int, int],
                 device="cuda", mesh: Mesh = LOCAL):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        h, w, c = img_shape
        if h != w:
            raise ValueError(f"square images expected, got {h}x{w}")
        self.img_shape = tuple(img_shape)
        dt = DTYPES[cfg.run.compute_dtype]
        with torch.device(self.device):
            self.gen = Generator(img_size=h, nz=cfg.latent_dim, ngf=cfg.ngf,
                                 nc=c, dtype=dt)
            self.disc = Discriminator(img_size=h, ndf=cfg.ndf, nc=c,
                                      dtype=dt, fused=cfg.run.fused_conv)
        set_group(mesh.data_group, self.gen, self.disc)
        self.opts: Dict[str, torch.optim.Optimizer] = {}
        self.step = 0

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self, name) for name in NETS}

    def _fresh_optimizers(self) -> None:
        cfg = self.cfg
        self.opts = {name: adam(net.parameters(), cfg.lr, b1=cfg.beta1,
                                b2=cfg.beta2, capturable=True)
                     for name, net in self.nets().items()}

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded DCGAN init of both networks, fresh Adams."""
        for net in self.nets().values():
            net.init_parameters(generator)
        self._fresh_optimizers()
        self.step = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every parameter and BN buffer, keyed ``<net>.<name>``."""
        return {f"{name}.{k}": v for name, net in self.nets().items()
                for k, v in net.state_dict().items()}

    def load(self, params: Dict[str, torch.Tensor],
             opt_state: Optional[Dict[str, dict]] = None,
             step: int = 0) -> None:
        """Load ``state_dict()``-style params (strict per network) and, when
        given, both optimizers' state_dicts."""
        for name, net in self.nets().items():
            prefix = f"{name}."
            net.load_state_dict({k[len(prefix):]: v for k, v in params.items()
                                 if k.startswith(prefix)}, strict=True)
        if not self.opts:
            self._fresh_optimizers()
        if opt_state is not None:
            for name, opt in self.opts.items():
                opt.load_state_dict(opt_state[name])
        self.step = int(step)

    def opt_state(self) -> Dict[str, dict]:
        return {name: opt.state_dict() for name, opt in self.opts.items()}

    def _z(self, given, shape, generator, axis: int = 0) -> torch.Tensor:
        """This rank's rows (batch ``axis``) of z for the global batch."""
        if given is not None:
            glob = list(shape)
            glob[axis] *= self.mesh.data
            return self.mesh.rows(given.to(self.device, torch.float32)
                                  .reshape(glob), axis)
        return batch_draw(self.mesh, lambda s: torch.randn(
            s, generator=generator, device=self.device), shape, axis)

    def _labels(self, value: float, b: int) -> torch.Tensor:
        return torch.full((b,), value, dtype=torch.float32,
                          device=self.device)

    def d_loss(self, x: torch.Tensor, fake: torch.Tensor,
               wgan: bool = False) -> torch.Tensor:
        """D's loss, real forward first (each advances D's running stats):
        bce(D(x), 1) + bce(D(fake), 0), or under ``wgan`` mean(D(fake)) -
        mean(D(x))."""
        out_real = self.disc(x, train=True)
        out_fake = self.disc(fake, train=True)
        if wgan:
            return out_fake.mean() - out_real.mean()
        b = x.shape[0]
        return (bce(out_real, self._labels(1.0, b))
                + bce(out_fake, self._labels(0.0, b)))

    def g_loss(self, z: torch.Tensor, wgan: bool = False) -> torch.Tensor:
        """G's loss on z through D, both in train mode (D advances its
        running stats and records no gradient): bce(D(G(z)), 1), or under
        ``wgan`` -mean(D(G(z)))."""
        with frozen_parameters(self.disc):
            out = self.disc(self.gen(latent_to_spatial(z), train=True),
                            train=True)
        return -out.mean() if wgan else bce(out,
                                            self._labels(1.0, z.shape[0]))

    def _g_step(self, z: torch.Tensor, wgan: bool) -> torch.Tensor:
        """One G step on ``g_loss``."""
        opt_g = self.opts["gen"]
        opt_g.zero_grad(set_to_none=True)
        g_loss = self.g_loss(z, wgan)
        g_loss.backward()
        average_grads(self.gen.parameters(), self.mesh.data_group)
        opt_g.step()
        opt_g.zero_grad(set_to_none=True)
        return g_loss

    # ------------------------------------------------------------------ DCGAN
    def train_step(self, batch_uint8: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One DCGAN step (module docstring); z (B, latent)."""
        x = to_signed(batch_uint8.to(self.device))
        z = self._z(z, (x.shape[0], self.cfg.latent_dim), generator)
        with torch.no_grad(), frozen_running_stats(self.gen):
            fake = self.gen(latent_to_spatial(z), train=True)
        opt_d = self.opts["disc"]
        opt_d.zero_grad(set_to_none=True)
        d_loss = self.d_loss(x, fake)
        d_loss.backward()
        average_grads(self.disc.parameters(), self.mesh.data_group)
        opt_d.step()
        opt_d.zero_grad(set_to_none=True)
        g_loss = self._g_step(z, wgan=False)
        self.step += 1
        return mean_metrics({"d_loss": d_loss.detach(),
                             "g_loss": g_loss.detach()}, self.mesh)

    # ------------------------------------------------------------------- WGAN
    def train_step_wgan(self, batch_uint8: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        z: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """One WGAN step (module docstring); z (critic_iters + 1, B,
        latent): one per critic step, the last for the G step."""
        cfg = self.cfg
        x = to_signed(batch_uint8.to(self.device))
        z = self._z(z, (cfg.critic_iters + 1, x.shape[0], cfg.latent_dim),
                    generator, axis=1)
        opt_d = self.opts["disc"]
        for i in range(cfg.critic_iters):
            with torch.no_grad():
                fake = self.gen(latent_to_spatial(z[i]), train=True)
            opt_d.zero_grad(set_to_none=True)
            d_loss = self.d_loss(x, fake, wgan=True)
            d_loss.backward()
            average_grads(self.disc.parameters(), self.mesh.data_group)
            opt_d.step()
            clamp_params(self.disc, cfg.clip_value)
        opt_d.zero_grad(set_to_none=True)
        g_loss = self._g_step(z[-1], wgan=True)
        self.step += 1
        return mean_metrics({"d_loss": d_loss.detach(),
                             "g_loss": g_loss.detach()}, self.mesh)

    @torch.inference_mode()
    def generate(self, z: torch.Tensor) -> torch.Tensor:
        """Generator in eval mode on z (N, latent) or (N, 1, 1, latent):
        images in [-1, 1]."""
        z = z.to(self.device)
        if z.ndim == 2:
            z = latent_to_spatial(z)
        return self.gen(z, train=False)
