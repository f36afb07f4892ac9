"""VAE-GAN trainer, the flagship workload (``vgd_tpu/train/vaegan.py``).

One train step, as in the JAX package:

1. ``recon0``: encode -> reparameterize -> decode in train mode (batch
   statistics) with no gradient, and with the encoder's and decoder's
   running stats left untouched (``frozen_running_stats``): they change
   once per step, in the G step.
2. ``d_steps`` (2) discriminator steps, each an Adam update of D on
   ``bce(D(x + noise_real), 0.9) + bce(D(recon0 + noise_fake), 0.1)``; every
   D forward runs in train mode and advances D's running stats from the
   previous forward's (4 updates over the two steps).
3. One G step: encode -> reparameterize -> decode with gradient, pixel MSE
   (or the "disl" D-feature MSE) + alpha_kl * ramp * KL / batch + alpha_adv
   * bce(D(recon + noise_fake), 0.9). The gradient flows through D into the
   decoder and the encoder, and only their two Adams step; D's forward
   advances its running stats a fifth time, and that update is kept. D
   gets no Adam step and keeps no ``.grad``.

``train_step`` can be captured as a CUDA graph (the epoch scan,
``common.StepGraph``): its KL ramp may be a 0-d tensor the caller fills
before each epoch, so one capture serves the whole run (a float works
too), and its Adams are ``capturable`` on a card.

The draws come from the caller or, in this order, from an explicit
``torch.Generator``: ``eps`` (B, latent) for the reparameterisation (one
draw for ``recon0`` and the G step), then ``noise_real`` and
``noise_fake`` (standard normal, the image's shape; scaled by
``instance_noise`` here), shared by both D steps and the G step. Metrics
stay 0-d device tensors; the caller decides when to read them.

``cfg.run.fused_conv`` runs the encoder's and discriminator's train-mode
Conv4x4s2 + BN + LeakyReLU through K1; eval and ``generate`` never do.

Under data parallelism (``mesh``) the trainer holds this rank's rows of
the global batch: every draw is made for the global batch and sliced
(caller-given draws are the global batch's too), every BatchNorm takes the
global batch's statistics, the gradients are averaged over the data axis
before each of the three Adams' steps (``collectives.average_grads``), and
the losses come back as the global batch's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from vgd_tpu_torch.core.config import VAEGANConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.models.blocks import frozen_running_stats, set_group
from vgd_tpu_torch.models.gan import Discriminator, Generator
from vgd_tpu_torch.models.vae import (Encoder, kl_divergence,
                                      latent_to_spatial, reparameterize)
from vgd_tpu_torch.ops.image import to_signed
from vgd_tpu_torch.parallel.collectives import average_grads
from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
from vgd_tpu_torch.train.common import (DTYPES, adam, batch_draw,
                                         bce, frozen_parameters, mean_metrics,
                                         mse)

NETS = ("encoder", "decoder", "disc")


class VAEGANTrainer:
    """The three networks, their three Adams and the step on ``device``."""

    def __init__(self, cfg: VAEGANConfig, img_shape: Tuple[int, int, int],
                 device="cuda", mesh: Mesh = LOCAL):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        h, w, c = img_shape
        if h != w:
            raise ValueError(f"square images expected, got {h}x{w}")
        self.img_shape = tuple(img_shape)
        dt = DTYPES[cfg.run.compute_dtype]
        fused = cfg.run.fused_conv
        with torch.device(self.device):
            self.encoder = Encoder(h, c, cfg.latent_dim, dtype=dt,
                                   fused=fused)
            self.decoder = Generator(img_size=h, nz=cfg.latent_dim,
                                     ngf=cfg.ngf, nc=c, dtype=dt)
            self.disc = Discriminator(img_size=h, ndf=cfg.ndf, nc=c,
                                      dtype=dt, fused=fused)
        set_group(mesh.data_group, self.encoder, self.decoder, self.disc)
        self.opts: Dict[str, torch.optim.Optimizer] = {}
        self.step = 0

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self, name) for name in NETS}

    def _fresh_optimizers(self) -> None:
        self.opts = {name: adam(net.parameters(), self.cfg.lr,
                                capturable=True)
                     for name, net in self.nets().items()}

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init of the three networks (Flax defaults for the
        encoder, DCGAN for decoder and discriminator), fresh Adams."""
        for net in self.nets().values():
            net.init_parameters(generator)
        self._fresh_optimizers()
        self.step = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every parameter and BN buffer of the three networks, keyed
        ``<net>.<name>``."""
        return {f"{name}.{k}": v for name, net in self.nets().items()
                for k, v in net.state_dict().items()}

    def load(self, params: Dict[str, torch.Tensor],
             opt_state: Optional[Dict[str, dict]] = None,
             step: int = 0) -> None:
        """Load ``state_dict()``-style params (strict per network) and, when
        given, the three optimizers' state_dicts."""
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

    # ----------------------------------------------------------------- pieces
    def encode_decode(self, x: torch.Tensor, eps: torch.Tensor):
        """encode -> clamp logvar -> reparameterize -> decode, train mode.
        Returns (mu, clamped logvar, recon)."""
        mu, logvar = self.encoder(x, train=True)
        z, logvar = reparameterize(mu, logvar, eps)
        return mu, logvar, self.decoder(latent_to_spatial(z), train=True)

    def d_loss(self, real_noisy: torch.Tensor,
               fake_noisy: torch.Tensor) -> torch.Tensor:
        """One D step's loss: real then fake forward (train mode, running
        stats advanced by each), smoothed labels."""
        b = real_noisy.shape[0]
        real = self.disc(real_noisy, train=True)
        fake = self.disc(fake_noisy, train=True)
        return (bce(real, self._labels(self.cfg.label_real, b))
                + bce(fake, self._labels(self.cfg.label_fake, b)))

    def g_loss(self, x: torch.Tensor, eps: torch.Tensor,
               real_noisy: torch.Tensor, noise_fake: torch.Tensor,
               kl_ramp: Union[float, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The G/E objective: (total, {"recon", "kl", "adv"}). D's forwards
        advance its running stats and record no gradient for its
        parameters; the gradient reaches the encoder and decoder through
        D's input."""
        cfg = self.cfg
        mu, logvar, recon = self.encode_decode(x, eps)
        with frozen_parameters(self.disc):
            if cfg.recon_loss == "disl":
                fake_out, fake_feat = self.disc(recon + noise_fake,
                                                train=True,
                                                return_features=True)
                _, real_feat = self.disc(real_noisy, train=True,
                                         return_features=True)
                recon_loss = mse(fake_feat, real_feat.detach())
            else:
                fake_out = self.disc(recon + noise_fake, train=True)
                recon_loss = mse(recon, x)
        kl = kl_divergence(mu, logvar, mean_over_batch=True)
        adv = bce(fake_out, self._labels(cfg.label_real, x.shape[0]))
        total = recon_loss + cfg.alpha_kl * kl_ramp * kl + cfg.alpha_adv * adv
        return total, {"recon": recon_loss, "kl": kl, "adv": adv}

    def _labels(self, value: float, b: int) -> torch.Tensor:
        return torch.full((b,), value, dtype=torch.float32,
                          device=self.device)

    def _draw(self, given, shape, generator):
        """This rank's rows of a standard normal draw for the global batch
        (``given``, or from ``generator``)."""
        if given is not None:
            return self.mesh.rows(given).to(self.device, torch.float32)
        return batch_draw(self.mesh, lambda s: torch.randn(
            s, generator=generator, device=self.device), shape)

    # ------------------------------------------------------------------- step
    def train_step(self, batch_uint8: torch.Tensor,
                   kl_ramp: Union[float, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None,
                   noise_real: Optional[torch.Tensor] = None,
                   noise_fake: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One VAE-GAN step (module docstring) on this rank's rows of the
        global batch; returns the five losses of the global batch as 0-d
        device tensors: recon, kl, adv, d_loss (the last D step's),
        g_total."""
        cfg = self.cfg
        x = to_signed(batch_uint8.to(self.device))
        eps = self._draw(eps, (x.shape[0], cfg.latent_dim), generator)
        noise_real = cfg.instance_noise * self._draw(noise_real, x.shape,
                                                     generator)
        noise_fake = cfg.instance_noise * self._draw(noise_fake, x.shape,
                                                     generator)
        with torch.no_grad(), frozen_running_stats(self.encoder,
                                                   self.decoder):
            _, _, recon0 = self.encode_decode(x, eps)
        real_noisy = x + noise_real
        fake_noisy = recon0 + noise_fake

        opt_dis = self.opts["disc"]
        for _ in range(cfg.d_steps):
            opt_dis.zero_grad(set_to_none=True)
            d_loss = self.d_loss(real_noisy, fake_noisy)
            d_loss.backward()
            average_grads(self.disc.parameters(), self.mesh.data_group)
            opt_dis.step()
        opt_dis.zero_grad(set_to_none=True)

        total, parts = self.g_loss(x, eps, real_noisy, noise_fake, kl_ramp)
        params = [p for name in ("encoder", "decoder")
                  for p in self.nets()[name].parameters()]
        grads = torch.autograd.grad(total, params)
        for p, g in zip(params, grads):
            p.grad = g
        average_grads(params, self.mesh.data_group)
        self.opts["encoder"].step()
        self.opts["decoder"].step()
        for name in ("encoder", "decoder"):
            self.opts[name].zero_grad(set_to_none=True)
        self.step += 1
        return mean_metrics({**{k: v.detach() for k, v in parts.items()},
                             "d_loss": d_loss.detach(),
                             "g_total": total.detach()}, self.mesh)

    @torch.no_grad()
    def eval_step(self, batch_uint8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """The denoising validation pass in eval mode (running stats): the
        clean batch plus ``val_noise_std`` noise, clipped, through encoder
        and decoder. Draws: ``noise`` (image shape), then ``eps``. Returns
        val_loss, per-sample per_mse and per_kl (so the caller can drop a
        padded batch's repeats), recon and noisy."""
        cfg = self.cfg
        img = to_signed(batch_uint8.to(self.device))
        noise = self._draw(noise, img.shape, generator)
        eps = self._draw(eps, (img.shape[0], cfg.latent_dim), generator)
        noisy = torch.clamp(img + cfg.val_noise_std * noise, -1.0, 1.0)
        mu, logvar = self.encoder(noisy, train=False)
        z, logvar = reparameterize(mu, logvar, eps)
        recon = self.decoder(latent_to_spatial(z), train=False)
        kl = kl_divergence(mu, logvar, mean_over_batch=False)
        per_mse = torch.square(recon.float() - img.float()).mean(
            dim=(1, 2, 3))
        per_kl = -0.5 * torch.sum(1.0 + logvar - torch.square(mu)
                                  - torch.exp(logvar), dim=1)
        return {"val_loss": mse(recon, img) + cfg.alpha_kl * kl,
                "per_mse": per_mse, "per_kl": per_kl, "recon": recon,
                "noisy": noisy}

    @torch.inference_mode()
    def generate(self, z: torch.Tensor) -> torch.Tensor:
        """Decoder in eval mode on z (N, latent): images in [-1, 1]."""
        return self.decoder(latent_to_spatial(z.to(self.device)),
                            train=False)

    def kl_ramp(self, epoch: int) -> float:
        return min(1.0, epoch / self.cfg.kl_warmup_epochs)
