"""Denoising VAE trainer (``vgd_tpu/train/vae.py``).

The encoder (``models.vae.Encoder``) and a DCGAN ``Generator`` as decoder,
one joint Adam at lr 1e-3 over the encoder's parameters, then the
decoder's (the optax state's ``{"enc", "dec"}`` tree). One train step:

1. the batch corrupted: clean + ``noise_max_std`` (0.5 when unset) times a
   standard normal draw, clamped to [-1, 1]; or, with
   ``cfg.data.occlusion``, ``data.corrupt.corrupt`` (an occlusion
   rectangle, then per-sample-std noise);
2. encode in train mode (batch statistics; the running stats advance) ->
   reparameterize -> decode in train mode;
3. loss = MSE(recon, clean) + KL (raw sum) * ramp * ``kl_weight``, one Adam
   step of both networks.

``train_step`` can be captured as a CUDA graph (the epoch scan,
``common.StepGraph``): its KL ramp may be a 0-d tensor the caller fills
before each epoch, and its Adam is ``capturable`` on a card.

The draws come from the caller or, in this order, from an explicit
``torch.Generator``: the noise (a standard normal of the image's shape, or
``CorruptDraws`` with occlusion), then ``eps`` (B, latent). Metrics stay
0-d device tensors.

``cfg.run.fused_conv`` runs the encoder's train-mode Conv4x4s2 + BN +
LeakyReLU through K1; validation, ``denoise`` and ``generate`` run in
eval mode and never do.

Under data parallelism (``mesh``) the trainer holds this rank's rows of
the global batch: every draw is made for the global batch and sliced
(caller-given draws are the global batch's too), the BatchNorms take the
global batch's statistics, the KL term (a sum over the batch) is this
rank's sum times the data axis, so that each rank's loss estimates the
global one, the gradients are averaged over the data axis before the Adam
step, and the losses come back as the global batch's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from vgd_tpu_torch.core.config import VAEConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.data.corrupt import CorruptDraws, corrupt, corrupt_draws
from vgd_tpu_torch.models.blocks import set_group
from vgd_tpu_torch.models.gan import Generator
from vgd_tpu_torch.models.vae import (Encoder, kl_divergence,
                                      latent_to_spatial, reparameterize)
from vgd_tpu_torch.ops.image import to_signed
from vgd_tpu_torch.parallel.collectives import average_grads
from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
from vgd_tpu_torch.train.common import (DTYPES, adam, batch_draw,
                                         mean_metrics, mse)

NETS = ("encoder", "decoder")


class VAETrainer:
    """Encoder, decoder, their joint Adam and the step on ``device``."""

    def __init__(self, cfg: VAEConfig, img_shape: Tuple[int, int, int],
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
            self.encoder = Encoder(h, c, cfg.latent_dim, dtype=dt,
                                   fused=cfg.run.fused_conv)
            self.decoder = Generator(img_size=h, nz=cfg.latent_dim,
                                     ngf=cfg.ngf, nc=c, dtype=dt)
        set_group(mesh.data_group, self.encoder, self.decoder)
        self.opt: Optional[torch.optim.Optimizer] = None
        self.step = 0

    @property
    def noise_std(self) -> float:
        return self.cfg.data.noise_max_std or 0.5

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self, name) for name in NETS}

    def parameters(self):
        """The joint optimizer's parameters: the encoder's, then the
        decoder's."""
        return [p for net in self.nets().values() for p in net.parameters()]

    def _fresh_optimizer(self) -> None:
        self.opt = adam(self.parameters(), self.cfg.lr, capturable=True)

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init (Flax defaults for the encoder, DCGAN for the
        decoder), a fresh Adam."""
        for net in self.nets().values():
            net.init_parameters(generator)
        self._fresh_optimizer()
        self.step = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every parameter and BN buffer, keyed ``<net>.<name>``."""
        return {f"{name}.{k}": v for name, net in self.nets().items()
                for k, v in net.state_dict().items()}

    def load(self, params: Dict[str, torch.Tensor],
             opt_state: Optional[dict] = None, step: int = 0) -> None:
        """Load ``state_dict()``-style params (strict per network) and, when
        given, the Adam's state_dict."""
        for name, net in self.nets().items():
            prefix = f"{name}."
            net.load_state_dict({k[len(prefix):]: v for k, v in params.items()
                                 if k.startswith(prefix)}, strict=True)
        if self.opt is None:
            self._fresh_optimizer()
        if opt_state is not None:
            self.opt.load_state_dict(opt_state)
        self.step = int(step)

    def _draw(self, given, shape, generator):
        """This rank's rows of a standard normal draw for the global batch
        (``given``, or from ``generator``)."""
        if given is not None:
            return self.mesh.rows(given).to(self.device, torch.float32)
        return batch_draw(self.mesh, lambda s: torch.randn(
            s, generator=generator, device=self.device), shape)

    def corrupt_batch(self, img: torch.Tensor, noise=None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """The training corruption of ``img`` with ``noise`` (a standard
        normal of the image's shape, or ``CorruptDraws`` with
        ``cfg.data.occlusion``; drawn from ``generator`` when None)."""
        if self.cfg.data.occlusion:
            return corrupt(img, self.noise_std,
                           self._corrupt_draws(noise, img, generator))
        noise = self._draw(noise, img.shape, generator)
        return torch.clamp(img + self.noise_std * noise, -1.0, 1.0)

    def _corrupt_draws(self, given, img, generator) -> CorruptDraws:
        """This rank's rows of ``corrupt``'s draws for the global batch."""
        if given is not None:
            return self.mesh.rows(given)
        return batch_draw(self.mesh, lambda s: corrupt_draws(
            s, generator, self.device), img.shape)

    def loss(self, img: torch.Tensor, noisy: torch.Tensor, eps: torch.Tensor,
             kl_ramp: Union[float, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {recon, kl}) of the train-mode forward on ``noisy``
        against the clean ``img``, with ``eps`` (B, latent)."""
        mu, logvar = self.encoder(noisy, train=True)
        z, logvar = reparameterize(mu, logvar, eps)
        recon = self.decoder(latent_to_spatial(z), train=True)
        recon_loss = mse(recon, img)
        # a sum over the batch: this rank's share, scaled to the global sum
        kl = kl_divergence(mu, logvar, mean_over_batch=False) * self.mesh.data
        total = recon_loss + kl * kl_ramp * self.cfg.kl_weight
        return total, {"recon": recon_loss, "kl": kl}

    # ------------------------------------------------------------------- step
    def train_step(self, batch_uint8: torch.Tensor,
                   kl_ramp: Union[float, torch.Tensor],
                   noise=None, eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step (module docstring). ``noise``: a standard normal of the
        image's shape, or ``CorruptDraws`` with ``cfg.data.occlusion``.
        Returns total, recon and kl as 0-d device tensors."""
        img = to_signed(batch_uint8.to(self.device))
        noisy = self.corrupt_batch(img, noise, generator)
        eps = self._draw(eps, (img.shape[0], self.cfg.latent_dim), generator)
        total, parts = self.loss(img, noisy, eps, kl_ramp)
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        average_grads(self.parameters(), self.mesh.data_group)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1
        return mean_metrics({"total": total.detach(),
                             **{k: v.detach() for k, v in parts.items()}},
                            self.mesh)

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar clamped to [-10, 10]) of x in [-1, 1], eval mode."""
        mu, logvar = self.encoder(x.to(self.device), train=False)
        return mu, torch.clamp(logvar, -10.0, 10.0)

    @torch.no_grad()
    def denoise(self, noisy: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The product capability: encode -> reparameterize -> decode, eval
        mode. ``noisy`` is float NHWC in [-1, 1]; ``eps`` (B, latent), or
        (1, latent) for one draw shared by the batch."""
        noisy = noisy.to(self.device)
        mu, logvar = self.encoder(noisy, train=False)
        eps = self._draw(eps, mu.shape, generator)
        z, _ = reparameterize(mu, logvar, eps)
        return self.decoder(latent_to_spatial(z), train=False)

    @torch.no_grad()
    def eval_step(self, batch_uint8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  std_u: Optional[torch.Tensor] = None,
                  noise=None, eps: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """Validation with a random per-batch std: the clean batch plus
        ``std_u * noise_max_std`` times ``noise``, clamped (with occlusion:
        ``corrupt`` with ``noise`` as its ``CorruptDraws``, and ``std_u``
        unused), then ``denoise`` with ``eps``. Draws: ``std_u`` (0-d),
        ``noise``, ``eps``. Returns val_loss (MSE + raw-sum KL), the
        per-sample per_mse and per_kl (so the caller can drop a padded
        batch's repeats), recon and noisy."""
        cfg = self.cfg
        img = to_signed(batch_uint8.to(self.device))
        if cfg.data.occlusion:
            noisy = corrupt(img, self.noise_std,
                            self._corrupt_draws(noise, img, generator))
        else:
            if std_u is None:
                std_u = torch.rand((), generator=generator,
                                   device=self.device)
            std = std_u.to(self.device, torch.float32) * self.noise_std
            noise = self._draw(noise, img.shape, generator)
            noisy = torch.clamp(img + std * noise, -1.0, 1.0)
        eps = self._draw(eps, (img.shape[0], cfg.latent_dim), generator)
        recon = self.denoise(noisy, eps)
        mu, logvar = self.encode(noisy)
        kl = kl_divergence(mu, logvar, mean_over_batch=False)
        per_mse = torch.square(recon.float() - img.float()).mean(
            dim=(1, 2, 3))
        per_kl = -0.5 * torch.sum(1.0 + logvar - torch.square(mu)
                                  - torch.exp(logvar), dim=1)
        return {"val_loss": mse(recon, img) + kl, "per_mse": per_mse,
                "per_kl": per_kl, "recon": recon, "noisy": noisy}

    @torch.inference_mode()
    def generate(self, z: torch.Tensor) -> torch.Tensor:
        """Decoder in eval mode on z (N, latent): images in [-1, 1]."""
        return self.decoder(latent_to_spatial(z.to(self.device)),
                            train=False)

    def kl_ramp(self, epoch: int) -> float:
        return min(epoch / self.cfg.kl_warmup_epochs, 1.0)

