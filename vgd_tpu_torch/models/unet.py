"""DDPM UNet (with and without attention), counterpart of
``vgd_tpu/models/unet.py``.

Public ``UNet.forward(x, t)`` takes NHWC images, as the Flax module does, and
every activation stays NHWC: a convolution sees the NCHW permutation of an
NHWC tensor, which is PyTorch's channels_last layout, so no copy is made and
cuDNN keeps its output channels_last. Dtypes follow the Flax module exactly:
convs and Dense layers compute in ``dtype`` (bf16 by default) from f32
parameters; GroupNorm, LayerNorm, attention, the time MLP and the output
conv run in f32, at the same places where ``unet.py`` casts to ``F32``.

``fused=True`` routes attention (K3) and every GroupNorm+SiLU (K4) through
the port's kernels (``ops.kernels``), as the JAX package does on its
inference paths. ``fused=False`` is the training form: attention runs the
differentiable K2 kernels (``kernels.attention``), as the JAX train step's
``attention`` does, and GroupNorm+SiLU stays stock PyTorch. Under sequence
parallelism (``UNet.sp_group``, the mesh's model group; JAX's ``sp_mesh``)
the bottleneck self-attention runs the ring
(``parallel.sequence_parallel.sp_self_attention``) in both forms, ahead of
``fused``; the cross-attentions keep K2 / K3, and every other layer runs
replicated over the model group.

Parameter names mirror the Flax tree (``down1.conv1.weight`` for
``params['down1']['conv1']['kernel']``) so ``io.jax_params`` maps them one
to one. ``UNet.init_parameters`` follows Flax's default initialisers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vgd_tpu_torch.ops import conv
from vgd_tpu_torch.ops.conv import nchw, nhwc
from vgd_tpu_torch.ops.initializers import lecun_normal_
from vgd_tpu_torch.ops.kernels import (attention, flash_attention,
                                       groupnorm_silu, groupnorm_silu_plain)
from vgd_tpu_torch.parallel.sequence_parallel import sp_self_attention

F32 = torch.float32


class Conv(conv.Conv):
    """Flax ``nn.Conv`` (odd square kernel, SAME padding) on NHWC input."""

    def __init__(self, in_ch: int, out_ch: int, k: int, dtype: torch.dtype):
        super().__init__(in_ch, out_ch, k, padding=k // 2, dtype=dtype)


class Dense(nn.Module):
    """Flax ``nn.Dense``: weight (out, in) here, kernel (in, out) there."""

    def __init__(self, in_f: int, out_f: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.empty(out_f))
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupNormSiLU(nn.Module):
    """GroupNorm(8) + SiLU in f32, NHWC. ``fused=True`` runs the K4 kernel,
    which also takes the cast of its output (``out_dtype``), a residual
    added in f32 before that cast (``residual``), a per-(image, channel)
    ``shift`` (B, C) added to x in x's dtype before the norm, and the
    biases of the convolutions x and the residual come from
    (``conv_bias``, ``residual_bias``, (C,)), each added in its tensor's
    dtype before anything else, reading x in its own dtype. The training
    form (``fused=False``) computes the same function in stock PyTorch ops
    under autograd and no kernel (the adds, then the norm of
    ``x.float()``): the JAX train step keeps the XLA form there
    (``vgd_tpu/models/unet.py`` GroupNormSiLU) and K4 has no backward. Both
    return f32 unless given ``out_dtype``."""

    def __init__(self, channels: int, groups: int = 8, fused: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = groups
        self.fused = fused

    def forward(self, x, out_dtype=None, residual=None, shift=None,
                conv_bias=None, residual_bias=None):
        if self.fused:
            return groupnorm_silu(
                x.contiguous(), self.weight, self.bias, self.groups,
                out_dtype=F32 if out_dtype is None else out_dtype,
                residual=None if residual is None else residual.contiguous(),
                shift=shift, conv_bias=conv_bias, residual_bias=residual_bias)
        if conv_bias is not None:
            x = x + conv_bias.to(x.dtype)
        if shift is not None:
            x = x + shift[:, None, None, :].to(x.dtype)
        if residual_bias is not None:
            residual = residual + residual_bias.to(residual.dtype)
        return groupnorm_silu_plain(x.float(), self.weight, self.bias,
                                    self.groups, out_dtype=out_dtype,
                                    residual=residual)


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """sin/cos embedding of integer timesteps; frequencies divide by
    ``half - 1`` as in the reference."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=F32, device=timesteps.device) / (half - 1))
    args = timesteps.to(F32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class ConvBlock(nn.Module):
    """Residual double conv with additive time embedding. The time
    projection is added after ``conv1`` and before ``gn1``, in the conv's
    dtype; the residual add runs in f32 and is cast back. With ``fused``
    the conv outputs go into K4 in their own dtype without their biases,
    and K4 adds each conv's bias and the time projection as it reads
    conv1's and conv2's output, the 1x1 residual conv's bias as it reads
    the residual, and writes gn1's cast and gn2's residual add and cast
    itself; the training form runs the biased convs and adds the
    projection with a stock op."""

    def __init__(self, in_ch: int, out_ch: int, time_emb_dim: int,
                 dtype: torch.dtype, fused: bool):
        super().__init__()
        self.dtype = dtype
        self.residual_conv = (Conv(in_ch, out_ch, 1, dtype)
                              if in_ch != out_ch else None)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype)
        self.time_proj = Dense(time_emb_dim, out_ch, F32)
        self.gn1 = GroupNormSiLU(out_ch, fused=fused)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype)
        self.gn2 = GroupNormSiLU(out_ch, fused=fused)

    def forward(self, x, t_emb):
        if self.gn1.fused:
            return self._fused(x, t_emb)
        res = x if self.residual_conv is None else self.residual_conv(x)
        h = self.conv1(x)
        # the add rebinds h, so conv1's output is freed before gn1
        h = h + self.time_proj(t_emb)[:, None, None, :].to(h.dtype)
        h = self.gn1(h, out_dtype=self.dtype)
        return self.gn2(self.conv2(h), out_dtype=self.dtype, residual=res)

    def _fused(self, x, t_emb):
        rc = self.residual_conv
        res, res_bias = (x, None) if rc is None else (rc.unbiased(x), rc.bias)
        h = self.conv1.unbiased(x)
        h = self.gn1(h, out_dtype=self.dtype, shift=self.time_proj(t_emb),
                     conv_bias=self.conv1.bias)
        return self.gn2(self.conv2.unbiased(h), out_dtype=self.dtype,
                        residual=res, conv_bias=self.conv2.bias,
                        residual_bias=res_bias)


class AttentionBlock(nn.Module):
    """Single-head self-attention over the HW tokens, with residual. The
    1x1 qkv conv's channels split q | k | v. With ``sp_group`` the tokens
    ride the ring over that group (sequence parallelism)."""

    def __init__(self, channels: int, dtype: torch.dtype, fused: bool):
        super().__init__()
        self.norm = nn.GroupNorm(8, channels, eps=1e-5)
        self.qkv = Conv(channels, channels * 3, 1, dtype)
        self.proj = Conv(channels, channels, 1, dtype)
        self.dtype = dtype
        self.fused = fused
        self.sp_group = None

    def forward(self, x):
        b, hh, ww, c = x.shape
        h = nhwc(self.norm(nchw(x.float())))
        qkv = self.qkv(h.to(self.dtype)).reshape(b, hh * ww, 3 * c)
        q, k, v = (t.float().contiguous() for t in qkv.split(c, dim=-1))
        if self.sp_group is not None:
            out = sp_self_attention(q, k, v, self.sp_group,
                                    scale=1.0 / math.sqrt(c))
        else:
            attend = flash_attention if self.fused else attention
            out = attend(q, k, v, scale=1.0 / math.sqrt(c))
        out = out.reshape(b, hh, ww, c)
        return self.proj(out.to(self.dtype)).float() + x.float()


class CrossAttentionToGlobalTokens(nn.Module):
    """Pixels query ``num_tokens`` learned global tokens. LayerNorm eps 1e-5;
    ``to_kv`` output splits k | v."""

    def __init__(self, dim: int, dtype: torch.dtype, fused: bool,
                 num_tokens: int = 64, token_dim: int = 256):
        super().__init__()
        self.global_tokens = nn.Parameter(torch.empty(1, num_tokens, token_dim))
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = Dense(dim, token_dim, dtype)
        self.to_kv = Dense(token_dim, token_dim * 2, dtype)
        self.proj = Dense(token_dim, dim, dtype)
        self.token_dim = token_dim
        self.dtype = dtype
        self.fused = fused

    def forward(self, x):
        b, hh, ww, c = x.shape
        x_ = x.reshape(b, hh * ww, c)
        q = self.to_q(self.norm(x_.float()).to(self.dtype))
        # The Flax module projects the tokens broadcast to the batch; every
        # row is the same, so they are projected once and expanded (autograd
        # sums dk/dv over the batch back into the one projection).
        k, v = self.to_kv(self.global_tokens.to(self.dtype)).split(
            self.token_dim, dim=-1)
        k = k.float().expand(b, -1, -1).contiguous()
        v = v.float().expand(b, -1, -1).contiguous()
        attend = flash_attention if self.fused else attention
        h = attend(q.float().contiguous(), k, v,
                   scale=1.0 / math.sqrt(self.token_dim))
        h = self.proj(h.to(self.dtype))
        return h.float().reshape(b, hh, ww, c) + x.float()


def max_pool2(x):
    """MaxPool2d(2) on NHWC."""
    return nhwc(F.max_pool2d(nchw(x), 2))


def upsample2_bilinear(x):
    """x2 bilinear, align_corners=False (half-pixel centres), NHWC; equals
    ``jax.image.resize(..., 'bilinear')`` for upsampling, edges included."""
    return nhwc(F.interpolate(nchw(x), scale_factor=2, mode="bilinear",
                               align_corners=False))


def _cat(a, b):
    """Channel concat with JAX's dtype promotion (bf16 with f32 -> f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=-1)


class UNet(nn.Module):
    """3-level DDPM UNet; ``attention=False`` is the no-attention variant.
    The reference builds a level-3 self-attention it never calls; it is left
    out here as in the JAX package."""

    def __init__(self, in_ch: int = 3, out_ch: int = 3, base_ch: int = 64,
                 time_emb_dim: int = 256, attention: bool = True,
                 dtype: torch.dtype = F32, fused: bool = False):
        super().__init__()
        c, ted = base_ch, time_emb_dim
        self.time_emb_dim = ted
        self.attention = attention
        self.dtype = dtype
        self.time_mlp1 = Dense(ted, ted * 4, F32)
        self.time_mlp2 = Dense(ted * 4, ted, F32)
        self.down1 = ConvBlock(in_ch, c, ted, dtype, fused)
        self.down2 = ConvBlock(c, c * 2, ted, dtype, fused)
        self.down3 = ConvBlock(c * 2, c * 4, ted, dtype, fused)
        self.bottleneck = ConvBlock(c * 4, c * 4, ted, dtype, fused)
        if attention:
            self.cross_attn2 = CrossAttentionToGlobalTokens(c * 2, dtype, fused)
            self.cross_attn3 = CrossAttentionToGlobalTokens(c * 4, dtype, fused)
            self.attn_bottleneck = AttentionBlock(c * 4, dtype, fused)
        self.up3 = ConvBlock(c * 8, c * 2, ted, dtype, fused)
        self.up2 = ConvBlock(c * 4, c, ted, dtype, fused)
        self.up1 = ConvBlock(c * 2, c, ted, dtype, fused)
        self.out_conv = Conv(c, out_ch, 1, F32)
        self.forwards = 0   # forward calls, read by serving metrics

    @property
    def sp_group(self):
        """The model group the bottleneck self-attention's tokens are
        sharded over (None: no sequence parallelism)."""
        return self.attn_bottleneck.sp_group if self.attention else None

    @sp_group.setter
    def sp_group(self, group):
        if self.attention:
            self.attn_bottleneck.sp_group = group

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax defaults: truncated lecun-normal kernels, zero biases, ones
        and zeros for norms, normal(1.0) for the global tokens."""
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.reset_parameters(generator)
            elif isinstance(mod, (GroupNormSiLU, nn.GroupNorm, nn.LayerNorm)):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, CrossAttentionToGlobalTokens):
                nn.init.normal_(mod.global_tokens, 0.0, 1.0,
                                generator=generator)
        return self

    def forward(self, x, t):
        """x (B, H, W, C) NHWC, t (B,) integer timesteps -> (B, H, W, out)
        f32 noise prediction."""
        self.forwards += 1
        t_emb = sinusoidal_embedding(t, self.time_emb_dim)
        t_emb = self.time_mlp2(F.silu(self.time_mlp1(t_emb)))

        d1 = self.down1(x.to(self.dtype), t_emb)
        d2 = self.down2(max_pool2(d1), t_emb)
        if self.attention:
            d2 = self.cross_attn2(d2)
        d3 = self.down3(max_pool2(d2), t_emb)
        if self.attention:
            d3 = self.cross_attn3(d3)
        b = self.bottleneck(max_pool2(d3), t_emb)
        if self.attention:
            b = self.attn_bottleneck(b)
        u3 = self.up3(_cat(upsample2_bilinear(b), d3), t_emb)
        u2 = self.up2(_cat(upsample2_bilinear(u3), d2), t_emb)
        u1 = self.up1(_cat(upsample2_bilinear(u2), d1), t_emb)
        return self.out_conv(u1.float())
