"""Plain f32 reference of Glow (Kingma & Dhariwal, 2018) on images, with
the widths and forms of rosinality's glow-pytorch (``model.py``,
``train.py``): its train step, the data-dependent ActNorm init and the
exact bits-per-dimension loss. Nothing of the program is imported.

NHWC, with the leaf names of the program's ``state_dict``: block i's K
flows stacked along a leading axis (``block{i}.flows.actnorm.b`` (K, c),
HWIO conv kernels ``block{i}.flows.coupling.conv1.w`` (K, 3, 3, c/2, f)),
its prior ``block{i}.prior.{w, b, scale}``.

* n-bit input: x = floor(u / 255 * 255 / 2^(8 - n)) / 2^n - 0.5 for uint8
  u (``train.py``'s ``ToTensor`` then ``* 255``), plus U(0, 1 / 2^n)
  dequantisation noise drawn from the step's generator;
* a block: squeeze (2x2 pixels into channels, channel c * 4 + a * 2 + s),
  K flows, then a split: half the channels go on, the other half z are
  scored under N(mean, exp(log_sd)^2) with mean | log_sd a ZeroConv of the
  half that goes on; the last block keeps every channel as z;
* a flow: ActNorm y = s (x + b), logdet H W sum log|s|; the invertible 1x1
  convolution W = P (L + I) (U + diag(sign(s) exp(log_s))) in its LU form,
  logdet H W sum log_s; an additive coupling yb + NN(ya) of the two
  channel halves;
* the ActNorm init, on the first batch: b = -mean, s = 1 / (unbiased std +
  1e-6) of each flow's input over (B, H, W);
* the loss: -(log p(z) + logdet - n_pixel ln(2^n)) / (n_pixel ln 2), the
  batch's mean, with log_p and logdet reported apart in the same units.

Departures from the paper, rosinality's forms, which the program follows:

* NN is conv 3x3 (f) + bias -> ReLU -> conv 1x1 (f) + bias -> ReLU ->
  ZeroConv, biases where the paper puts ActNorm inside the network;
* a ZeroConv pads its input with the value 1, not 0, and scales its 3x3
  convolution by exp(3 scale);
* the last block's prior is a ZeroConv of zeros (its bias and the border
  of ones), not a learned constant;
* the split prior is a ZeroConv of the half that goes on, as in the paper's
  code ("learntop" off).

The configuration computes the coupling network's three convolutions and
the 1x1 convolution in bf16; ``lowp`` is applied to their operands. The
priors and everything else stay f32 in the program and here.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.ops import Adam, conv, exact, make_params

# the benchmark's random weights: the program's init draws the coupling
# kernels N(0, 0.05) and zeroes every ZeroConv, whose zeros would give the
# first gradients of conv1 and conv2 exactly 0; here the ZeroConvs of the
# flows and the priors are drawn too
KERNEL_STD = 0.05
ZERO_STD = 0.01


def blocks(cfg: dict) -> List[Tuple[int, int, bool]]:
    """(channels after the squeeze, side after it, split) of each block."""
    out, ch, side = [], cfg["channels"], cfg["image_size"]
    for i in range(cfg["n_blocks"]):
        side //= 2
        split = i < cfg["n_blocks"] - 1
        out.append((ch * 4, side, split))
        ch *= 2
    return out


def param_specs(cfg: dict):
    """[(name, shape, mean, std)] of the trained leaves: coupling kernels
    N(0, ``KERNEL_STD``), zero conv1 / conv2 biases, every ZeroConv's
    kernel, bias and scale N(0, ``ZERO_STD``), ActNorm b = 0 and s = 1
    (until the init). The 1x1 convolutions' L, U and log_s are listed as
    zeros; ``weights`` draws them."""
    k, f = cfg["n_flows"], cfg["filter_size"]
    specs = []
    for i, (c, _, split) in enumerate(blocks(cfg)):
        pre, h = f"block{i}.flows.", c // 2
        specs += [
            (pre + "actnorm.b", (k, c), 0.0, 0.0),
            (pre + "actnorm.s", (k, c), 1.0, 0.0),
            (pre + "invconv.L", (k, c, c), 0.0, 0.0),
            (pre + "invconv.U", (k, c, c), 0.0, 0.0),
            (pre + "invconv.log_s", (k, c), 0.0, 0.0),
            (pre + "coupling.conv1.w", (k, 3, 3, h, f), 0.0, KERNEL_STD),
            (pre + "coupling.conv1.b", (k, f), 0.0, 0.0),
            (pre + "coupling.conv2.w", (k, 1, 1, f, f), 0.0, KERNEL_STD),
            (pre + "coupling.conv2.b", (k, f), 0.0, 0.0),
            (pre + "coupling.zero.w", (k, 3, 3, f, h), 0.0, ZERO_STD),
            (pre + "coupling.zero.b", (k, h), 0.0, ZERO_STD),
            (pre + "coupling.zero.scale", (k, h), 0.0, ZERO_STD)]
        cin, cout = (h, c) if split else (c, 2 * c)
        specs += [(f"block{i}.prior.w", (3, 3, cin, cout), 0.0, ZERO_STD),
                  (f"block{i}.prior.b", (cout,), 0.0, ZERO_STD),
                  (f"block{i}.prior.scale", (cout,), 0.0, ZERO_STD)]
    return specs


BUFFERS = ("invconv.P", "invconv.s_sign")


def weights(cfg: dict, generator: torch.Generator, device) -> dict:
    """The leaves of ``param_specs`` (``ops.make_params``), then each
    block's K 1x1 convolutions as the program's init draws them: the LU
    pieces of the Q of a normal (K, c, c) matrix's QR, P and sign(s) as
    buffers. f32, by ``state_dict`` name."""
    p = make_params(param_specs(cfg), generator, device)
    for i, (c, _, _) in enumerate(blocks(cfg)):
        pre = f"block{i}.flows.invconv."
        w = torch.randn((cfg["n_flows"], c, c), generator=generator,
                        device=device)
        q, _ = torch.linalg.qr(w)
        perm, lower, upper = torch.linalg.lu(q)
        diag = torch.diagonal(upper, dim1=-2, dim2=-1)
        p.update({pre + "P": perm, pre + "L": lower,
                  pre + "U": torch.triu(upper, 1),
                  pre + "log_s": torch.log(diag.abs()),
                  pre + "s_sign": torch.sign(diag)})
    return p


def trained(name: str) -> bool:
    return not name.endswith(BUFFERS)


def groups(cfg: dict) -> Dict[str, tuple]:
    """The leaves' groups for the check (name prefixes): the coupling
    networks, ActNorm with the 1x1 convolutions, and the priors. One Adam
    step updates all of them."""
    n = range(cfg["n_blocks"])
    return {"coupling": tuple(f"block{i}.flows.coupling." for i in n),
            "norm": tuple(f"block{i}.flows.{m}." for i in n
                          for m in ("actnorm", "invconv")),
            "prior": tuple(f"block{i}.prior." for i in n)}


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def squeeze(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel c * 4 + a * 2 + s for the
    pixel (2i + a, 2j + s)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def zero_conv(x, w, b, scale, lowp=exact):
    """3x3 convolution of x padded with ones, + b, times exp(3 scale)."""
    x = F.pad(x, (0, 0, 1, 1, 1, 1), value=1.0)
    return conv(x, _oihw(w), b, 1, 0, lowp) * torch.exp(3.0 * scale)


def coupling_nn(p, pre, k, ya, lowp):
    h = torch.relu(conv(ya, _oihw(p[pre + "conv1.w"][k]),
                        p[pre + "conv1.b"][k], 1, 1, lowp))
    h = torch.relu(conv(h, _oihw(p[pre + "conv2.w"][k]),
                        p[pre + "conv2.b"][k], 1, 0, lowp))
    return zero_conv(h, p[pre + "zero.w"][k], p[pre + "zero.b"][k],
                     p[pre + "zero.scale"][k], lowp)


def plu(p, pre) -> torch.Tensor:
    """The K weights W = P (L + I) (U + diag(sign(s) exp(log_s)))."""
    lo, up = p[pre + "invconv.L"], p[pre + "invconv.U"]
    c = lo.shape[-1]
    eye = torch.eye(c, dtype=lo.dtype, device=lo.device)
    lower = torch.tril(lo, -1) + eye
    upper = torch.triu(up, 1) + torch.diag_embed(
        p[pre + "invconv.s_sign"] * torch.exp(p[pre + "invconv.log_s"]))
    return p[pre + "invconv.P"] @ lower @ upper


def gaussian_log_p(x, mean, log_sd):
    return (-0.5 * math.log(2 * math.pi) - log_sd
            - 0.5 * (x - mean) ** 2 / torch.exp(2.0 * log_sd))


def forward(p, x, cfg, lowp=exact, init: bool = False):
    """(log p(z) (B,), logdet (), ActNorm (b, s) by leaf name) of the
    dequantised x (B, H, W, C). With ``init`` each flow's b and s come
    from its input's statistics (and are returned); else from ``p``."""
    log_p = torch.zeros(x.shape[0], device=x.device)
    logdet = torch.zeros((), device=x.device)
    stats = {}
    for i, (c, side, split) in enumerate(blocks(cfg)):
        pre = f"block{i}.flows."
        x = squeeze(x)
        hw = side * side
        w = plu(p, pre)
        bs, ss = [], []
        for k in range(cfg["n_flows"]):
            if init:
                mean = x.mean(dim=(0, 1, 2))
                std = x.std(dim=(0, 1, 2), correction=1)
                b, s = -mean, 1.0 / (std + 1e-6)
            else:
                b, s = p[pre + "actnorm.b"][k], p[pre + "actnorm.s"][k]
            bs.append(b)
            ss.append(s)
            y = (s * (x + b)).reshape(-1, c)
            y = (lowp(y) @ lowp(w[k].t())).reshape(x.shape)
            ya, yb = y.chunk(2, dim=-1)
            x = torch.cat([ya, yb + coupling_nn(p, pre + "coupling.", k, ya,
                                                lowp)], dim=-1)
        s_all = torch.stack(ss)
        logdet = logdet + hw * (torch.log(s_all.abs()).sum()
                                + p[pre + "invconv.log_s"].sum())
        if init:
            stats[pre + "actnorm.b"] = torch.stack(bs)
            stats[pre + "actnorm.s"] = s_all
        pw, pb, psc = (p[f"block{i}.prior.{n}"] for n in ("w", "b", "scale"))
        if split:
            x, z = x.chunk(2, dim=-1)
            mean, log_sd = zero_conv(x, pw, pb, psc).chunk(2, dim=-1)
        else:
            z = x
            mean, log_sd = zero_conv(torch.zeros_like(x), pw, pb,
                                     psc).chunk(2, dim=-1)
        log_p = log_p + gaussian_log_p(z, mean, log_sd).reshape(
            x.shape[0], -1).sum(1)
    return log_p, logdet, stats


def draws(generator, cfg, batch, device):
    """The U(0, 1) draw of one step's dequantisation noise."""
    s = cfg["image_size"]
    return torch.rand((batch, s, s, cfg["channels"]), generator=generator,
                      device=device)


def dequantised(batch_uint8, generator, cfg) -> torch.Tensor:
    n_bins = 2.0 ** cfg["n_bits"]
    x = batch_uint8.to(torch.float32) / 255.0 * 255.0
    x = torch.floor(x / 2 ** (8 - cfg["n_bits"])) / n_bins - 0.5
    return x + draws(generator, cfg, x.shape[0], x.device) / n_bins


def loss_terms(log_p, logdet, cfg):
    """(loss, log_p, logdet) in bits per dimension, batch means."""
    n_pixel = cfg["image_size"] ** 2 * cfg["channels"]
    scale = math.log(2.0) * n_pixel
    total = log_p + logdet - math.log(2.0 ** cfg["n_bits"]) * n_pixel
    return (-total / scale).mean(), (log_p / scale).mean(), logdet / scale


@torch.no_grad()
def init_actnorm(params, batch, generator, cfg, lowp=exact) -> dict:
    """ActNorm's data-dependent init on ``batch`` (one draw of
    ``generator``): sets every flow's b and s in ``params``; returns
    them."""
    _, _, stats = forward(params, dequantised(batch, generator, cfg), cfg,
                          lowp, init=True)
    params.update(stats)
    return stats


def train_steps(params, batches, generator, cfg, lowp, tap=None, adam=None):
    """``len(batches)`` train steps from ``params`` (updated in place) and
    ``adam``; each step's loss, log_p and logdet as floats. ``tap(step,
    adam)`` after each step."""
    adam = adam or Adam(cfg["lr"])
    names = [k for k in params if trained(k)]
    out = []
    for i, batch in enumerate(batches):
        x = dequantised(batch, generator, cfg)
        leaves = {**params, **{k: params[k].detach().requires_grad_(True)
                               for k in names}}
        log_p, logdet, _ = forward(leaves, x, cfg, lowp)
        loss, lp, ld = loss_terms(log_p, logdet, cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        adam.step(params, dict(zip(names, grads)))
        out.append({"loss": float(loss.detach()), "log_p": float(lp.detach()),
                    "logdet": float(ld.detach())})
        if tap is not None:
            tap(i, adam)
    return out
