"""Plain f32 reference of DDPM (Ho et al., 2020) with the UNet of the
reference repository's ``train_diffusion.py``: its train step and the DDIM
sampler (Song et al., 2021) with eta = 0.

UNet, NHWC, with the leaf names of the program's ``state_dict``, base
width c and time embedding d:

* time embedding: sin / cos of t times exp(-ln(10^4) i / (d/2 - 1)), then
  Dense(d, 4d), SiLU, Dense(4d, d);
* ConvBlock(in, out): 3x3 conv, plus Dense(d, out) of the embedding, then
  GroupNorm(8) + SiLU, 3x3 conv, GroupNorm(8) + SiLU, plus the input (a
  1x1 conv of it where in != out);
* down1 (3 -> c), pool, down2 (c -> 2c), [cross attention of the pixels to
  64 learned tokens of width 256], pool, down3 (2c -> 4c), [cross
  attention], pool, bottleneck (4c -> 4c), [single-head self-attention
  with GroupNorm and 1x1 q|k|v and output convs, residual]; up3, up2, up1
  on the bilinear x2 upsample concatenated with the skip (8c -> 2c, 4c ->
  c, 2c -> c); a 1x1 output conv. The bracketed layers exist with
  ``attention``.
* cross attention: q = Dense(LayerNorm(x)), k | v = Dense(tokens),
  softmax(q k^T / 16) v, a Dense back to the width, residual.

The configuration computes the convolutions and the attention layers'
Dense products in bf16; ``lowp`` is applied there. The time MLP, the time
projections, the output conv and the attention products stay f32 in the
program and here.

Train step: t ~ U{0..T-1} then the noise, drawn in that order from the
step's generator; loss = mean((UNet(sqrt(abar_t) x0 + sqrt(1 - abar_t)
noise, t) - noise)^2); one Adam step. The schedule is linear in beta from
``beta_start`` to ``beta_end``, worked out in float64 and rounded to f32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ops import (Adam, attention, conv, exact,
                                     group_norm, lecun_std, linear,
                                     max_pool2, signed, upsample2)

TOKENS, TOKEN_DIM = 64, 256


def _blocks(c):
    return [("down1", 3, c), ("down2", c, 2 * c), ("down3", 2 * c, 4 * c),
            ("bottleneck", 4 * c, 4 * c), ("up3", 8 * c, 2 * c),
            ("up2", 4 * c, c), ("up1", 2 * c, c)]


def param_specs(cfg: dict):
    """[(name, shape, mean, std)]: lecun-normal kernels, zero biases, unit
    norm scales, N(0, 1) tokens."""
    c, d = cfg["base_ch"], cfg["time_emb_dim"]
    specs = []

    def dense(name, i, o):
        specs.extend([(f"{name}.weight", (o, i), 0.0, lecun_std(i)),
                      (f"{name}.bias", (o,), 0.0, 0.0)])

    def convp(name, i, o, k):
        specs.extend([(f"{name}.weight", (o, i, k, k), 0.0,
                       lecun_std(i * k * k)),
                      (f"{name}.bias", (o,), 0.0, 0.0)])

    def norm(name, ch):
        specs.extend([(f"{name}.weight", (ch,), 1.0, 0.0),
                      (f"{name}.bias", (ch,), 0.0, 0.0)])

    dense("time_mlp1", d, 4 * d)
    dense("time_mlp2", 4 * d, d)
    for name, i, o in _blocks(c):
        if i != o:
            convp(f"{name}.residual_conv", i, o, 1)
        convp(f"{name}.conv1", i, o, 3)
        dense(f"{name}.time_proj", d, o)
        norm(f"{name}.gn1", o)
        convp(f"{name}.conv2", o, o, 3)
        norm(f"{name}.gn2", o)
    if cfg["attention"]:
        for name, dim in (("cross_attn2", 2 * c), ("cross_attn3", 4 * c)):
            specs.append((f"{name}.global_tokens", (1, TOKENS, TOKEN_DIM),
                          0.0, 1.0))
            norm(f"{name}.norm", dim)
            dense(f"{name}.to_q", dim, TOKEN_DIM)
            dense(f"{name}.to_kv", TOKEN_DIM, 2 * TOKEN_DIM)
            dense(f"{name}.proj", TOKEN_DIM, dim)
        norm("attn_bottleneck.norm", 4 * c)
        convp("attn_bottleneck.qkv", 4 * c, 12 * c, 1)
        convp("attn_bottleneck.proj", 4 * c, 4 * c, 1)
    convp("out_conv", c, 3, 1)
    return specs


# The leaves of the train step's one optimizer step (the check's numbers
# carry no suffix).
GROUPS = {"": ("",)}
# No group's step is taken from a run's state after it (see the VAE-GAN).
FORCED = {}


def trained(name: str) -> bool:
    return True


def _embedding(t, d):
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def _block(p, name, x, temb, lowp):
    res = (conv(x, p[f"{name}.residual_conv.weight"],
                p[f"{name}.residual_conv.bias"], 1, 0, lowp)
           if f"{name}.residual_conv.weight" in p else x)
    h = conv(x, p[f"{name}.conv1.weight"], p[f"{name}.conv1.bias"], 1, 1, lowp)
    h = h + linear(temb, p[f"{name}.time_proj.weight"],
                   p[f"{name}.time_proj.bias"])[:, None, None, :]
    h = F.silu(group_norm(h, p[f"{name}.gn1.weight"], p[f"{name}.gn1.bias"]))
    h = conv(h, p[f"{name}.conv2.weight"], p[f"{name}.conv2.bias"], 1, 1, lowp)
    return F.silu(group_norm(h, p[f"{name}.gn2.weight"],
                             p[f"{name}.gn2.bias"])) + res


def _cross(p, name, x, lowp):
    b, hh, ww, c = x.shape
    x_ = x.reshape(b, hh * ww, c)
    q = linear(F.layer_norm(x_, (c,), p[f"{name}.norm.weight"],
                            p[f"{name}.norm.bias"], 1e-5),
               p[f"{name}.to_q.weight"], p[f"{name}.to_q.bias"], lowp)
    kv = linear(p[f"{name}.global_tokens"], p[f"{name}.to_kv.weight"],
                p[f"{name}.to_kv.bias"], lowp)
    k, v = (t.expand(b, -1, -1) for t in kv.split(TOKEN_DIM, dim=-1))
    h = attention(q, k, v, 1.0 / math.sqrt(TOKEN_DIM))
    h = linear(h, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], lowp)
    return h.reshape(b, hh, ww, c) + x


def _self_attention(p, x, lowp):
    b, hh, ww, c = x.shape
    h = group_norm(x, p["attn_bottleneck.norm.weight"],
                   p["attn_bottleneck.norm.bias"])
    qkv = conv(h, p["attn_bottleneck.qkv.weight"],
               p["attn_bottleneck.qkv.bias"], 1, 0, lowp)
    q, k, v = qkv.reshape(b, hh * ww, 3 * c).split(c, dim=-1)
    out = attention(q, k, v, 1.0 / math.sqrt(c)).reshape(b, hh, ww, c)
    return conv(out, p["attn_bottleneck.proj.weight"],
                p["attn_bottleneck.proj.bias"], 1, 0, lowp) + x


def unet(p, x, t, cfg, lowp=exact):
    """Noise prediction (B, H, W, 3) f32 of x (B, H, W, 3), t (B,)."""
    temb = _embedding(t, cfg["time_emb_dim"])
    temb = linear(F.silu(linear(temb, p["time_mlp1.weight"],
                                p["time_mlp1.bias"])),
                  p["time_mlp2.weight"], p["time_mlp2.bias"])
    attn = cfg["attention"]
    d1 = _block(p, "down1", x, temb, lowp)
    d2 = _block(p, "down2", max_pool2(d1), temb, lowp)
    if attn:
        d2 = _cross(p, "cross_attn2", d2, lowp)
    d3 = _block(p, "down3", max_pool2(d2), temb, lowp)
    if attn:
        d3 = _cross(p, "cross_attn3", d3, lowp)
    b = _block(p, "bottleneck", max_pool2(d3), temb, lowp)
    if attn:
        b = _self_attention(p, b, lowp)
    u3 = _block(p, "up3", torch.cat([upsample2(b), d3], -1), temb, lowp)
    u2 = _block(p, "up2", torch.cat([upsample2(u3), d2], -1), temb, lowp)
    u1 = _block(p, "up1", torch.cat([upsample2(u2), d1], -1), temb, lowp)
    return conv(u1, p["out_conv.weight"], p["out_conv.bias"], 1, 0)


def alphas_cumprod(cfg, device) -> torch.Tensor:
    betas = np.linspace(cfg["beta_start"], cfg["beta_end"], cfg["timesteps"],
                        dtype=np.float64)
    return torch.from_numpy(np.cumprod(1.0 - betas)).to(device, torch.float32)


def draws(generator, cfg, batch, device):
    """t, then the noise, of one train step, in the program's order."""
    t = torch.randint(0, cfg["timesteps"], (batch,), generator=generator,
                      device=device)
    s = cfg["image_size"]
    noise = torch.randn((batch, s, s, cfg["channels"]), generator=generator,
                        device=device)
    return t, noise


def train_steps(params, batches, generator, cfg, lowp, tap=None, adam=None):
    """``len(batches)`` train steps from ``params`` (updated in place) and
    ``adam``; returns each step's {"loss": float}. ``tap(step, adam)`` as in
    the VAE-GAN reference."""
    acp = alphas_cumprod(cfg, batches[0].device)
    adam = adam or Adam(cfg["lr"])
    names = list(params)
    losses = []
    for i, batch in enumerate(batches):
        x0 = signed(batch)
        t, noise = draws(generator, cfg, x0.shape[0], x0.device)
        a = acp[t].sqrt()[:, None, None, None]
        s = (1.0 - acp[t]).sqrt()[:, None, None, None]
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        loss = torch.mean(torch.square(
            unet(leaves, a * x0 + s * noise, t, cfg, lowp) - noise))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        adam.step(params, dict(zip(names, grads)))
        losses.append({"loss": float(loss.detach())})
        if tap is not None:
            tap(i, adam)
    return losses


def ddim_timesteps(timesteps: int, steps: int):
    """Descending DDIM subsequence: evenly spaced over [0, T-1], rounded,
    duplicates removed."""
    ts = np.unique(np.round(np.linspace(0.0, timesteps - 1, steps)))
    return [int(t) for t in ts[::-1]]


@torch.no_grad()
def ddim_sample(params, x_t, steps, cfg, lowp=exact):
    """Deterministic DDIM (eta = 0) from x_t over ``steps`` timesteps, the
    step after the last with abar = 1; the result clamped to [-1, 1]."""
    acp = alphas_cumprod(cfg, x_t.device)
    acp = torch.cat([acp, torch.ones(1, device=x_t.device)])
    taus = ddim_timesteps(cfg["timesteps"], steps)
    x = x_t.float()
    for tau, prev in zip(taus, taus[1:] + [cfg["timesteps"]]):
        at, ap = acp[tau], acp[prev]
        eps = unet(params, x, torch.full((x.shape[0],), tau,
                                         device=x.device), cfg, lowp)
        x0 = (x - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        x = torch.sqrt(ap) * x0 + torch.sqrt(torch.clamp(1.0 - ap, min=0.0)) \
            * eps
    return torch.clamp(x, -1.0, 1.0)
