"""Plain f32 reference of the VAE-GAN train step (Larsen et al., 2016, at
the widths of the reference repository's ``vaegan_code.py``).

Networks, NHWC, with the leaf names of the program's ``state_dict``:

* encoder: four Conv 4x4 stride 2 VALID with bias, each followed by
  train-mode BatchNorm and LeakyReLU(0.01), channels 32, 64, 128, 256; the
  map flattened in (H, W, C) order into two Dense heads (mu, logvar);
* decoder (DCGAN generator): ConvTranspose 4x4 stride 1 from z (1 x 1) to
  4 x 4 with ngf * 16 channels, then ConvTranspose 4x4 stride 2 padding 1
  stages halving the channels up to the image size, each with BatchNorm and
  ReLU, then a 3x3 conv (no bias) and tanh;
* discriminator: Conv 4x4 stride 2 padding 1 (no bias) stages from ndf / 4
  channels, doubling, BatchNorm on all but the first, LeakyReLU(0.2), then
  a 4x4 VALID conv to one logit and a sigmoid.

One train step on x = pixels / 127.5 - 1, with draws in this order from
the step's generator: eps (B, latent), noise_real, noise_fake (the image's
shape, times ``instance_noise``): the reconstruction without gradient;
``d_steps`` Adam steps of the discriminator on bce(D(x + noise_real),
label_real) + bce(D(recon + noise_fake), label_fake); one Adam step of
encoder and decoder on mse(recon, x) + alpha_kl * ramp * KL / B +
alpha_adv * bce(D(recon + noise_fake), label_real), where logvar is
clamped to [-10, 10] before z = mu + exp(logvar / 2) eps. Every BatchNorm
takes the batch's statistics. The running statistics do not enter a train
step's outputs and are not computed.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.ops import (Adam, batch_norm, bce, conv,
                                     conv_transpose, lecun_std, linear,
                                     signed)

ENC_CHANNELS = (32, 64, 128, 256)
DCGAN_STD = 0.02


def _stages(size: int) -> int:
    n = 0
    while size > 4:
        size //= 2
        n += 1
    return n


def _valid(size: int) -> int:
    return (size - 4) // 2 + 1


def _bn(prefix, ch, scale_std=0.0):
    return [(f"{prefix}.weight", (ch,), 1.0, scale_std),
            (f"{prefix}.bias", (ch,), 0.0, 0.0),
            (f"{prefix}.running_mean", (ch,), 0.0, 0.0),
            (f"{prefix}.running_var", (ch,), 1.0, 0.0)]


def param_specs(cfg: dict):
    """[(name, shape, mean, std)] of every leaf and BatchNorm buffer:
    lecun-normal encoder kernels, N(0, 0.02) DCGAN kernels, N(1, 0.02)
    DCGAN BatchNorm scales, zero biases."""
    size, c, nz = cfg["image_size"], cfg["channels"], cfg["latent_dim"]
    specs, prev, s = [], c, size
    for i, ch in enumerate(ENC_CHANNELS):
        specs += [(f"encoder.conv{i}.weight", (ch, prev, 4, 4), 0.0,
                   lecun_std(prev * 16)),
                  (f"encoder.conv{i}.bias", (ch,), 0.0, 0.0)]
        specs += _bn(f"encoder.bn{i}", ch)
        prev, s = ch, _valid(s)
    flat = s * s * prev
    for head in ("fc_mu", "fc_logvar"):
        specs += [(f"encoder.{head}.weight", (nz, flat), 0.0, lecun_std(flat)),
                  (f"encoder.{head}.bias", (nz,), 0.0, 0.0)]
    ch0 = cfg["ngf"] * 16
    specs.append(("decoder.up0.weight", (nz, ch0, 4, 4), 0.0, DCGAN_STD))
    specs += _bn("decoder.bn0", ch0, DCGAN_STD)
    prev = ch0
    for i in range(1, _stages(size) + 1):
        ch = max(ch0 >> i, c)
        specs.append((f"decoder.up{i}.weight", (prev, ch, 4, 4), 0.0,
                      DCGAN_STD))
        specs += _bn(f"decoder.bn{i}", ch, DCGAN_STD)
        prev = ch
    specs.append(("decoder.out.weight", (c, prev, 3, 3), 0.0, DCGAN_STD))
    prev = c
    for i in range(_stages(size)):
        ch = (cfg["ndf"] // 4) << i
        specs.append((f"disc.down{i}.weight", (ch, prev, 4, 4), 0.0,
                      DCGAN_STD))
        if i > 0:
            specs += _bn(f"disc.bn{i}", ch, DCGAN_STD)
        prev = ch
    specs.append(("disc.out.weight", (1, prev, 4, 4), 0.0, DCGAN_STD))
    return specs


# The leaves of each optimizer step a train step takes, by the suffix the
# check's numbers carry: the discriminator's, and the encoder's and
# decoder's (one step together).
GROUPS = {"d": ("disc.",), "g": ("encoder.", "decoder.")}
# A group whose step the check takes from a run's own state after the
# step: (configuration overrides, the leaves taken from the run). The
# encoder and decoder's step runs with no D step and the run's own
# discriminator after the step's D steps, so that its gradient is held
# against what the run's discriminator gives, whatever Adam's sign-like
# updates of near-zero D gradients made of it.
FORCED = {"g": ({"d_steps": 0}, ("disc.",))}


def trained(name: str) -> bool:
    """Whether a leaf is a parameter (the BatchNorm buffers are not)."""
    return "running_" not in name


def encoder(p, x, lowp):
    h = x
    for i in range(len(ENC_CHANNELS)):
        h = conv(h, p[f"encoder.conv{i}.weight"], p[f"encoder.conv{i}.bias"],
                 2, 0, lowp)
        h = torch.nn.functional.leaky_relu(batch_norm(
            h, p[f"encoder.bn{i}.weight"], p[f"encoder.bn{i}.bias"]), 0.01)
    h = h.reshape(h.shape[0], -1)
    return (linear(h, p["encoder.fc_mu.weight"], p["encoder.fc_mu.bias"]),
            linear(h, p["encoder.fc_logvar.weight"],
                   p["encoder.fc_logvar.bias"]))


def decoder(p, z, size, lowp):
    h = z[:, None, None, :]
    for i in range(_stages(size) + 1):
        h = conv_transpose(h, p[f"decoder.up{i}.weight"], 1 if i == 0 else 2,
                           0 if i == 0 else 1, lowp)
        h = torch.relu(batch_norm(h, p[f"decoder.bn{i}.weight"],
                                  p[f"decoder.bn{i}.bias"]))
    return torch.tanh(conv(h, p["decoder.out.weight"], None, 1, 1, lowp))


def disc(p, x, size, lowp):
    h = x
    for i in range(_stages(size)):
        h = conv(h, p[f"disc.down{i}.weight"], None, 2, 1, lowp)
        if i > 0:
            h = batch_norm(h, p[f"disc.bn{i}.weight"], p[f"disc.bn{i}.bias"])
        h = torch.nn.functional.leaky_relu(h, 0.2)
    logit = conv(h, p["disc.out.weight"], None, 1, 0, lowp)
    return torch.sigmoid(logit.reshape(h.shape[0]))


def draws(generator, cfg, batch, device):
    """eps, noise_real, noise_fake of one step, in the program's order."""
    b = batch
    shape = (b, cfg["image_size"], cfg["image_size"], cfg["channels"])
    eps = torch.randn((b, cfg["latent_dim"]), generator=generator,
                      device=device)
    nr = torch.randn(shape, generator=generator, device=device)
    nf = torch.randn(shape, generator=generator, device=device)
    return eps, cfg["instance_noise"] * nr, cfg["instance_noise"] * nf


def _names(p, net):
    return [k for k in p if k.startswith(net + ".") and trained(k)]


def train_steps(params, batches, generator, cfg, lowp, kl_ramp=0.0,
                tap=None, adam=None):
    """``len(batches)`` train steps from ``params`` (a dict of f32 device
    tensors, updated in place) and ``adam`` (a fresh ``Adam`` by default).
    Returns each step's losses (recon, kl, adv, d_loss, g_total as
    floats). ``tap(step, adam)``, when given, is called after each step
    with the Adam state."""
    size = cfg["image_size"]
    adam = adam or Adam(cfg["lr"])
    losses = []
    for i, batch in enumerate(batches):
        x = signed(batch)
        eps, noise_real, noise_fake = draws(generator, cfg, x.shape[0],
                                            x.device)
        with torch.no_grad():
            mu, logvar = encoder(params, x, lowp)
            logvar = logvar.clamp(-10.0, 10.0)
            recon0 = decoder(params, mu + torch.exp(0.5 * logvar) * eps, size,
                             lowp)
        real_noisy, fake_noisy = x + noise_real, recon0 + noise_fake
        dn = _names(params, "disc")
        d_loss = torch.full((), math.nan)
        for _ in range(cfg["d_steps"]):
            leaves = {k: params[k].detach().requires_grad_(True) for k in dn}
            q = {**params, **leaves}
            d_loss = (bce(disc(q, real_noisy, size, lowp), cfg["label_real"])
                      + bce(disc(q, fake_noisy, size, lowp),
                            cfg["label_fake"]))
            grads = torch.autograd.grad(d_loss, list(leaves.values()))
            adam.step(params, dict(zip(dn, grads)))
        gn = _names(params, "encoder") + _names(params, "decoder")
        leaves = {k: params[k].detach().requires_grad_(True) for k in gn}
        q = {**params, **leaves}
        mu, logvar = encoder(q, x, lowp)
        logvar = logvar.clamp(-10.0, 10.0)
        recon = decoder(q, mu + torch.exp(0.5 * logvar) * eps, size, lowp)
        fake_out = disc(params, recon + noise_fake, size, lowp)
        recon_loss = torch.mean(torch.square(recon - x))
        kl = -0.5 * torch.sum(1.0 + logvar - torch.square(mu)
                              - torch.exp(logvar)) / x.shape[0]
        adv = bce(fake_out, cfg["label_real"])
        total = (recon_loss + cfg["alpha_kl"] * kl_ramp * kl
                 + cfg["alpha_adv"] * adv)
        grads = torch.autograd.grad(total, list(leaves.values()))
        adam.step(params, dict(zip(gn, grads)))
        losses.append({k: float(v.detach()) for k, v in (
            ("recon", recon_loss), ("kl", kl), ("adv", adv),
            ("d_loss", d_loss), ("g_total", total))})
        if tap is not None:
            tap(i, adam)
    return losses
