"""Glow normalizing flow, image and EEG variants (``vgd_tpu/models/glow.py``).

Layers, as in the JAX package:

* ActNorm: y = s (x + b), logdet = H W sum log|s|; the data-dependent init
  sets b = -mean, s = 1 / (unbiased std + 1e-6) from the first batch.
* Invertible 1x1 conv, PLU-parameterised: W = P (L + I) (U + diag(sign(s)
  exp(log_s))); P and sign(s) are buffers (no gradient, no optimizer state);
  logdet = H W sum log_s; the reverse by a permutation and two triangular
  solves.
* Additive coupling: yb + NN(ya), NN = Conv(f) -> ReLU -> Conv1x1(f) ->
  ReLU -> ZeroConv (value-1 padding, x exp(3 scale)); with
  ``fused_coupling`` NN is ``ops/glow_coupling.glow_coupling_nn`` (K5 on the
  card), else the stock conv chain in the compute dtype with the ZeroConv
  in f32.
* A block: squeeze, K flows, split with a ZeroConv prior; the last block
  has a prior on zeros. The model: L blocks, a list of z in and out.

The parameters keep the JAX tree: each block's K flows are stacked along a
leading K axis (one tensor per leaf, HWIO conv kernels), under the module
path of the JAX path (``block0/flows/coupling/conv1/w`` ->
``block0.flows.coupling.conv1.w``), so the weight bridge is a renaming. The
flows run in a Python loop over k (the JAX package scans them); each
forward unbinds the stacked leaves once, so their gradients are stacked
once per block.

Left out: ``remat`` (activation checkpointing), ``scan_unroll`` (an unroll
factor of ``lax.scan``, math-identical by construction, meaningless without
the scan), pipeline parallelism, and ``flow_stack`` (K6, the whole flow
chain as one kernel), which raises until it is ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vgd_tpu_torch.core.config import FLOW_STACK_NOT_PORTED
from vgd_tpu_torch.ops.glow_coupling import glow_coupling_nn


def gaussian_log_p(x, mean, log_sd):
    return (-0.5 * math.log(2 * math.pi) - log_sd
            - 0.5 * torch.square(x - mean) / torch.exp(2.0 * log_sd))


def gaussian_sample(eps, mean, log_sd):
    return mean + torch.exp(log_sd) * eps


# channel order c*4 + a*2 + s, the reference's torch reshape (checkpoint
# import depends on it)
def squeeze2d(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel = c*4 + a*2 + s."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def unsqueeze2d(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c4 = x.shape
    x = x.reshape(b, h, w, c4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * 2, w * 2, c4 // 4)


def squeeze_time(x: torch.Tensor) -> torch.Tensor:
    """EEG: (B, T, 1, C) -> (B, T/2, 1, 2C), channel = c*2 + a."""
    b, t, w, c = x.shape
    x = x.reshape(b, t // 2, 2, w, c).permute(0, 1, 3, 4, 2)
    return x.reshape(b, t // 2, w, c * 2)


def unsqueeze_time(x: torch.Tensor) -> torch.Tensor:
    b, t, w, c2 = x.shape
    x = x.reshape(b, t, w, c2 // 2, 2).permute(0, 1, 4, 2, 3)
    return x.reshape(b, t * 2, w, c2 // 2)


class Leaves(nn.Module):
    """Named parameter leaves (and buffers) of one node of the JAX tree."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t))
        for name, t in (buffers or {}).items():
            self.register_buffer(name, t)

    def tree(self) -> Dict[str, torch.Tensor]:
        return {**dict(self.named_parameters()), **dict(self.named_buffers())}


def _zeroconv_leaves(kh, kw, cin, cout) -> Leaves:
    return Leaves({"w": torch.zeros(kh, kw, cin, cout),
                   "b": torch.zeros(cout), "scale": torch.zeros(cout)})


class _Flows(nn.Module):
    """K flows' parameters, each leaf stacked along a leading K axis."""

    def __init__(self, n_flows, ch, filter_size, kh, kw):
        super().__init__()
        k, half, f = n_flows, ch // 2, filter_size
        self.actnorm = Leaves({"b": torch.zeros(k, ch),
                               "s": torch.ones(k, ch)})
        self.invconv = Leaves(
            {"L": torch.zeros(k, ch, ch), "U": torch.zeros(k, ch, ch),
             "log_s": torch.zeros(k, ch)},
            {"P": torch.eye(ch).repeat(k, 1, 1), "s_sign": torch.ones(k, ch)})
        self.coupling = nn.Module()
        self.coupling.conv1 = Leaves({"w": torch.zeros(k, kh, kw, half, f),
                                      "b": torch.zeros(k, f)})
        self.coupling.conv2 = Leaves({"w": torch.zeros(k, 1, 1, f, f),
                                      "b": torch.zeros(k, f)})
        self.coupling.zero = Leaves({"w": torch.zeros(k, kh, kw, f, half),
                                     "b": torch.zeros(k, half),
                                     "scale": torch.zeros(k, half)})

    def per_flow(self) -> List[Dict]:
        """One nested dict of views per flow (``unbind`` of every leaf)."""
        tree = {"actnorm": self.actnorm.tree(),
                "invconv": self.invconv.tree(),
                "coupling": {n: getattr(self.coupling, n).tree()
                             for n in ("conv1", "conv2", "zero")}}

        def split(node):
            if isinstance(node, dict):
                parts = {k: split(v) for k, v in node.items()}
                n = len(next(iter(parts.values())))
                return [{k: v[i] for k, v in parts.items()} for i in range(n)]
            return node.unbind(0)
        return split(tree)


class _Block(nn.Module):

    def __init__(self, n_flows, ch, filter_size, kh, kw, split):
        super().__init__()
        self.flows = _Flows(n_flows, ch, filter_size, kh, kw)
        self.prior = (_zeroconv_leaves(kh, kw, ch // 2, ch) if split
                      else _zeroconv_leaves(kh, kw, ch, ch * 2))


class Glow(nn.Module):
    """Glow over NHWC inputs. Parameters ``block{i}.flows.*`` (stacked over
    K) and ``block{i}.prior.*``; ``init_parameters`` draws them."""

    # finite guard of the reverse pass (see the JAX package): each flow's
    # output is clipped to +-1e6 and NaN set to 0, a no-op for sane values
    REV_GUARD = 1e6

    def __init__(self, in_channels=3, n_flows=32, n_blocks=4, variant="image",
                 filter_size=512, compute_dtype=torch.float32,
                 fused_coupling=False, flow_stack=False):
        super().__init__()
        if flow_stack is not False:
            raise NotImplementedError(FLOW_STACK_NOT_PORTED)
        if variant not in ("image", "eeg"):
            raise ValueError(f"variant {variant!r} (image or eeg)")
        self.in_channels, self.n_flows, self.n_blocks = (
            in_channels, n_flows, n_blocks)
        self.variant, self.filter_size = variant, filter_size
        self.compute_dtype = compute_dtype
        self.fused_coupling = fused_coupling
        self.kernel = (3, 3) if variant == "image" else (3, 1)
        self.pad = (1, 1) if variant == "image" else (1, 0)
        self.squeeze_factor = 4 if variant == "image" else 2
        kh, kw = self.kernel
        for i, ch in enumerate(self.block_in_channels()):
            setattr(self, f"block{i}", _Block(
                n_flows, ch * self.squeeze_factor, filter_size, kh, kw,
                split=i < n_blocks - 1))

    def block_in_channels(self) -> List[int]:
        chs, ch = [], self.in_channels
        for i in range(self.n_blocks):
            chs.append(ch)
            if self.variant == "image" and i < self.n_blocks - 1:
                ch *= 2              # EEG keeps its channels
        return chs

    def blocks(self) -> List[_Block]:
        return [getattr(self, f"block{i}") for i in range(self.n_blocks)]

    # -- init ---------------------------------------------------------------
    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None
                        ) -> None:
        """Conv kernels N(0, 0.05), zero biases, zero ZeroConvs (flows and
        priors), ActNorm b = 0 and s = 1 until ``init_actnorm``, and each
        1x1 conv the PLU pieces of the Q of a normal matrix's QR."""
        for blk in self.blocks():
            fl = blk.flows
            dev = fl.actnorm.b.device
            for leaf in (fl.coupling.conv1.w, fl.coupling.conv2.w):
                leaf.copy_(torch.randn(leaf.shape, generator=generator,
                                       device=dev) * 0.05)
            for t in (fl.coupling.conv1.b, fl.coupling.conv2.b,
                      *fl.coupling.zero.parameters(), *blk.prior.parameters(),
                      fl.actnorm.b):
                t.zero_()
            fl.actnorm.s.fill_(1.0)
            k, c = fl.actnorm.b.shape
            w = torch.randn((k, c, c), generator=generator, device=dev)
            q, _ = torch.linalg.qr(w)
            p, lo, u = torch.linalg.lu(q)
            s = torch.diagonal(u, dim1=-2, dim2=-1)
            inv = fl.invconv
            inv.P.copy_(p)
            inv.L.copy_(lo)
            inv.U.copy_(torch.triu(u, 1))
            inv.log_s.copy_(torch.log(torch.abs(s)))
            inv.s_sign.copy_(torch.sign(s))

    # -- primitive layers ---------------------------------------------------
    @staticmethod
    def _conv(p, x, pad, dtype):
        """NHWC conv with an HWIO kernel in ``dtype``, + bias."""
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2),
                     p["w"].to(dtype).permute(3, 2, 0, 1), padding=pad)
        return y.permute(0, 2, 3, 1) + p["b"].to(dtype)

    def _zeroconv(self, p, x):
        """Value-1 padding, VALID conv in f32, x exp(3 scale)."""
        ph, pw = self.pad
        x = F.pad(x, (0, 0, pw, pw, ph, ph), value=1.0)
        return self._conv(p, x, 0, torch.float32) * torch.exp(p["scale"] * 3.0)

    def _coupling_nn(self, p, xa):
        if self.fused_coupling:
            return glow_coupling_nn(p, xa.float(), self.kernel, self.pad,
                                    self.compute_dtype)
        cd = self.compute_dtype
        h = torch.relu(self._conv(p["conv1"], xa, self.pad, cd))
        h = torch.relu(self._conv(p["conv2"], h, 0, cd))
        return self._zeroconv(p["zero"], h.float())

    @staticmethod
    def _plu_weight(inv: Leaves) -> torch.Tensor:
        """W = P (L + I) (U + diag(sign(s) exp(log_s))), batched over K."""
        c = inv.L.shape[-1]
        eye = torch.eye(c, dtype=inv.L.dtype, device=inv.L.device)
        lower = inv.L * torch.tril(torch.ones_like(eye), -1) + eye
        upper = (inv.U * torch.triu(torch.ones_like(eye), 1)
                 + torch.diag_embed(inv.s_sign * torch.exp(inv.log_s)))
        return inv.P @ lower @ upper

    @staticmethod
    def _plu_solve(p, y):
        """x = W^{-1} y by the exact permutation and two triangular solves
        (no explicit inverse)."""
        c = p["L"].shape[0]
        eye = torch.eye(c, dtype=p["L"].dtype, device=p["L"].device)
        lower = p["L"] * torch.tril(torch.ones_like(eye), -1) + eye
        upper = (p["U"] * torch.triu(torch.ones_like(eye), 1)
                 + torch.diag(p["s_sign"] * torch.exp(p["log_s"])))
        b, h, w, _ = y.shape
        t = p["P"].t() @ y.reshape(-1, c).t()
        t = torch.linalg.solve_triangular(lower, t, upper=False,
                                          unitriangular=True)
        t = torch.linalg.solve_triangular(upper, t, upper=True)
        return t.t().reshape(b, h, w, c)

    def _rev_guard(self, x):
        g = self.REV_GUARD
        return torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=g, neginf=-g),
                           -g, g)

    # -- one flow -----------------------------------------------------------
    def _flow_fwd(self, p, x, hw, init, w, ld_pre):
        """ActNorm -> 1x1 conv -> additive coupling. Returns (y, logdet,
        (b, s)); in init mode b and s come from x's statistics and the
        logdet is recomputed from them."""
        if init:
            b = -torch.mean(x, dim=(0, 1, 2))
            s = 1.0 / (torch.std(x, dim=(0, 1, 2), correction=1) + 1e-6)
            logdet = hw * (torch.sum(torch.log(torch.abs(s)))
                           + torch.sum(p["invconv"]["log_s"]))
        else:
            b, s = p["actnorm"]["b"], p["actnorm"]["s"]
            logdet = ld_pre
        y = (s * (x + b)) @ w.t()
        ya, yb = y.chunk(2, dim=-1)
        out_b = yb + self._coupling_nn(p["coupling"], ya)
        return torch.cat([ya, out_b], dim=-1), logdet, (b, s)

    def _flow_rev(self, p, y):
        ya, yb = y.chunk(2, dim=-1)
        y = torch.cat([ya, yb - self._coupling_nn(p["coupling"], ya)], -1)
        y = self._plu_solve(p["invconv"], y)
        return self._rev_guard(y / p["actnorm"]["s"] - p["actnorm"]["b"])

    # -- block --------------------------------------------------------------
    def _squeeze(self, x):
        return squeeze2d(x) if self.variant == "image" else squeeze_time(x)

    def _unsqueeze(self, x):
        return unsqueeze2d(x) if self.variant == "image" \
            else unsqueeze_time(x)

    def _block_fwd(self, blk: _Block, x, split: bool, init: bool):
        bsz = x.shape[0]
        y = self._squeeze(x)
        hw = y.shape[1] * y.shape[2]
        fl = blk.flows
        # the K PLU weights and (ActNorm + 1x1 conv) logdets, batched
        w_all = self._plu_weight(fl.invconv)
        ld_all = hw * (torch.sum(torch.log(torch.abs(fl.actnorm.s)), dim=1)
                       + torch.sum(fl.invconv.log_s, dim=1))
        logdet = torch.zeros((), dtype=y.dtype, device=y.device)
        stats = []
        for k, p in enumerate(fl.per_flow()):
            y, ld, st = self._flow_fwd(p, y, hw, init, w_all[k], ld_all[k])
            logdet = logdet + ld
            stats.append(st)
        y, log_p, z_new = self._block_tail(blk, y, bsz, split)
        return y, logdet, log_p, z_new, stats

    def _block_tail(self, blk, y, bsz, split: bool):
        prior = blk.prior.tree()
        if split:
            y, z_new = y.chunk(2, dim=-1)
            mean, log_sd = self._zeroconv(prior, y).chunk(2, dim=-1)
        else:
            mean, log_sd = self._zeroconv(prior, torch.zeros_like(y)).chunk(
                2, dim=-1)
            z_new = y
        log_p = gaussian_log_p(z_new, mean, log_sd)
        return y, torch.sum(log_p.reshape(bsz, -1), dim=1), z_new

    def _block_rev(self, blk, y, eps, split: bool, reconstruct: bool):
        prior = blk.prior.tree()
        if reconstruct:
            x = torch.cat([y, eps], dim=-1) if split else eps
        elif split:
            mean, log_sd = self._zeroconv(prior, y).chunk(2, dim=-1)
            x = torch.cat([y, gaussian_sample(eps, mean, log_sd)], dim=-1)
        else:
            mean, log_sd = self._zeroconv(prior, torch.zeros_like(y)).chunk(
                2, dim=-1)
            x = gaussian_sample(eps, mean, log_sd)
        x = self._rev_guard(x)
        for p in reversed(blk.flows.per_flow()):
            x = self._flow_rev(p, x)
        return self._unsqueeze(x)

    # -- model --------------------------------------------------------------
    def forward(self, x: torch.Tensor, init: bool = False):
        """(log_p (B,), logdet (), z list[, per-block ActNorm stats])."""
        log_p_sum = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        logdet = torch.zeros((), dtype=x.dtype, device=x.device)
        z_outs, all_stats = [], []
        for i, blk in enumerate(self.blocks()):
            x, ld, lp, z_new, stats = self._block_fwd(
                blk, x, split=i < self.n_blocks - 1, init=init)
            z_outs.append(z_new)
            logdet = logdet + ld
            log_p_sum = log_p_sum + lp
            all_stats.append(stats)
        if init:
            return log_p_sum, logdet, z_outs, all_stats
        return log_p_sum, logdet, z_outs

    @torch.no_grad()
    def init_actnorm(self, x: torch.Tensor) -> None:
        """Data-dependent ActNorm init: one forward in init mode, then every
        flow's (b, s) from its input's statistics, in place."""
        _, _, _, stats = self.forward(x, init=True)
        for blk, st in zip(self.blocks(), stats):
            blk.flows.actnorm.b.copy_(torch.stack([b for b, _ in st]))
            blk.flows.actnorm.s.copy_(torch.stack([s for _, s in st]))

    @torch.no_grad()
    def reverse(self, z_list: Sequence[torch.Tensor],
                reconstruct: bool = False) -> torch.Tensor:
        x = None
        n = self.n_blocks
        for i in range(n - 1, -1, -1):
            blk = getattr(self, f"block{i}")
            if i == n - 1:       # the last block: no split, prior on zeros
                x = self._block_rev(blk, z_list[-1], z_list[-1], False,
                                    reconstruct)
            else:
                x = self._block_rev(blk, x, z_list[i], True, reconstruct)
        return x


def calc_z_shapes(n_channel: int, input_size: int, n_block: int
                  ) -> List[Tuple[int, int, int]]:
    """Latent shapes (H, W, C), image variant."""
    shapes = []
    size, ch = input_size, n_channel
    for _ in range(n_block - 1):
        size //= 2
        ch *= 2
        shapes.append((size, size, ch))
    size //= 2
    shapes.append((size, size, ch * 4))
    return shapes


def calc_z_shapes_eeg(num_chans: int, num_samples: int, n_block: int
                      ) -> List[Tuple[int, int, int]]:
    """Latent shapes (T, 1, C), EEG variant."""
    shapes = []
    t = num_samples
    for _ in range(n_block - 1):
        t //= 2
        shapes.append((t, 1, num_chans))
    t //= 2
    shapes.append((t, 1, num_chans * 2))
    return shapes


def calc_loss(log_p: torch.Tensor, logdet: torch.Tensor, image_size: int,
              n_bins: float, n_channels: int = 3):
    """Bits/dim: (loss, log_p, logdet), batch means over n_pixel * ln 2."""
    n_pixel = image_size * image_size * n_channels
    loss = -math.log(n_bins) * n_pixel + logdet + log_p
    scale = math.log(2) * n_pixel
    return (torch.mean(-loss / scale), torch.mean(log_p / scale),
            torch.mean(logdet / scale))
