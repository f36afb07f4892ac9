"""VAE test and analysis (``vgd_tpu/eval/vae_analysis.py``): the
sum-reduction denoising test loss with MSE / PSNR / SSIM, re-noise ->
re-encode cycles, and latent traversals. Each draw is passed in, or taken
from an explicit ``torch.Generator`` in the order stated per function.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from vgd_tpu_torch.eval.metrics import mse_metric, psnr, ssim
from vgd_tpu_torch.models.vae import latent_to_spatial, reparameterize
from vgd_tpu_torch.ops.image import signed_to_unit


def _normal(given, shape, generator, device) -> torch.Tensor:
    if given is not None:
        return given.to(device, torch.float32)
    return torch.randn(shape, generator=generator, device=device)


@torch.no_grad()
def denoise_test_loss(trainer, noisy: torch.Tensor, clean: torch.Tensor,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, object]:
    """Sum-reduction test loss (squared error summed + raw-sum KL) and the
    [0, 1] MSE / PSNR / SSIM of ``trainer.denoise(noisy, eps)`` against
    ``clean`` (both NHWC in [-1, 1]); ``recon`` beside them. Draws:
    ``eps`` (B, latent)."""
    dev = trainer.device
    noisy, clean = noisy.to(dev), clean.to(dev)
    eps = _normal(eps, (noisy.shape[0], trainer.cfg.latent_dim), generator,
                  dev)
    recon = trainer.denoise(noisy, eps)
    mu, logvar = trainer.encode(noisy)
    recon_sum = torch.sum(torch.square(recon - clean))
    kl = -0.5 * torch.sum(1 + logvar - torch.square(mu) - torch.exp(logvar))
    ru, cu = signed_to_unit(recon), signed_to_unit(clean)
    return {"test_loss": float(recon_sum + kl),
            "mse": float(mse_metric(ru, cu)), "psnr": float(psnr(ru, cu)),
            "ssim": float(ssim(ru, cu)), "recon": recon}


@torch.no_grad()
def renoise_cycle(trainer, noisy: torch.Tensor, noise_std: float = 0.25,
                  cycles: int = 2, draws=None,
                  generator: Optional[torch.Generator] = None
                  ) -> List[torch.Tensor]:
    """Denoise -> re-noise (``noise_std`` times a normal draw, clamped) ->
    denoise again, ``cycles`` times. ``draws``: per cycle (eps (B, latent),
    noise (image shape)), else drawn in that order. Returns [recon_1, ...,
    recon_cycles]."""
    dev = trainer.device
    outs = []
    x = noisy.to(dev)
    for i in range(cycles):
        eps, noise = draws[i] if draws is not None else (None, None)
        eps = _normal(eps, (x.shape[0], trainer.cfg.latent_dim), generator,
                      dev)
        recon = trainer.denoise(x, eps)
        outs.append(recon)
        noise = _normal(noise, recon.shape, generator, dev)
        x = torch.clamp(recon + noise_std * noise, -1.0, 1.0)
    return outs


@torch.no_grad()
def latent_traversal(trainer, image: torch.Tensor, dim: int = 0,
                     delta: float = 4.0, steps: int = 3, target: str = "mu",
                     eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Decode while shifting one latent statistic: step i adds
    ``delta * i`` to mu[:, dim] (``target="mu"``) or to the clamped
    logvar[:, dim], clamped again (``target="logvar"``); reparameterized
    with no further clamp. ``eps`` (steps + 1, B, latent), else drawn.
    Returns the first image's frames, (steps + 1, H, W, C)."""
    dev = trainer.device
    mu, logvar = trainer.encode(image.to(dev))
    eps = _normal(eps, (steps + 1,) + tuple(mu.shape), generator, dev)
    frames = []
    for i in range(steps + 1):
        mu_i, lv_i = mu.clone(), logvar.clone()
        if target == "mu":
            mu_i[:, dim] += delta * i
        else:
            lv_i[:, dim] += delta * i
            lv_i = torch.clamp(lv_i, -10.0, 10.0)
        z, _ = reparameterize(mu_i, lv_i, eps[i], clamp=False)
        recon = trainer.decoder(latent_to_spatial(z), train=False)
        frames.append(recon[0])
    return torch.stack(frames)
