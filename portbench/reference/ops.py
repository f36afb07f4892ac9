"""Plain PyTorch building blocks of the references, on NHWC activations.

Every op computes in f32. ``lowp`` is applied to the operands of the
convolutions and matrix products that the configuration computes in its
compute dtype: ``exact`` (the identity) for the reference, ``fp8`` for
the control, which rounds those operands to float8 e4m3 with a per-tensor
scale in the forward and their gradients to e5m2 in the backward: the
nearest precision below the configuration's bf16; ``bf16`` rounds them to
bfloat16, the configuration's own compute dtype (the sample cell's
yardstick of how far rounding alone moves a forward).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def exact_f32() -> None:
    """Matrix products and cuDNN convolutions in full f32 on a card (TF32
    off), so the reference computes what its dtype says."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, fmax: float
               ) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = fmax / amax
    return (x.float() * scale).to(dtype).float() / scale


class _FP8(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


class _BF16(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def bf16(x: torch.Tensor) -> torch.Tensor:
    return _BF16.apply(x)


PRECISIONS = {"float32": exact, "float8": fp8, "bfloat16": bf16}


def conv(x, w, b, stride=1, padding=0, lowp=exact):
    """x (B, H, W, Cin), w (Cout, Cin, k, k) -> (B, Ho, Wo, Cout)."""
    y = F.conv2d(lowp(x).permute(0, 3, 1, 2), lowp(w), b, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose(x, w, stride, padding, lowp=exact):
    """x (B, H, W, Cin), w (Cin, Cout, k, k), torch's transposed conv."""
    y = F.conv_transpose2d(lowp(x).permute(0, 3, 1, 2), lowp(w),
                           stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def linear(x, w, b, lowp=exact):
    return F.linear(lowp(x), lowp(w), b)


def batch_norm(x, w, b, eps=1e-5):
    """Train-mode batch normalisation of NHWC x over (B, H, W), biased
    variance."""
    var, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def group_norm(x, w, b, groups=8, eps=1e-5):
    """GroupNorm of NHWC x: groups of consecutive channels."""
    bsz, h, wd, c = x.shape
    xg = x.reshape(bsz, h * wd, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * w + b


def attention(q, k, v, scale):
    """softmax(q k^T scale) v, q (B, N, D), k / v (B, M, D)."""
    p = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * scale, dim=-1)
    return torch.bmm(p, v)


def max_pool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def upsample2(x):
    """x2 bilinear with half-pixel centres."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                         mode="bilinear", align_corners=False
                         ).permute(0, 2, 3, 1)


def bce(p, target: float):
    """Mean binary cross-entropy of probabilities against a constant."""
    return F.binary_cross_entropy(p, torch.full_like(p, target))


def signed(batch_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] in f32."""
    return batch_uint8.to(F32) / 127.5 - 1.0


def lecun_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in)


class Adam:
    """Adam (bias-corrected moments, eps outside the root) over named f32
    leaves, with a step count per leaf. ``first`` keeps each leaf's first
    gradient (of the first ``step`` call that updates it); ``load`` starts
    from given moments and counts."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, {}
        self.first = {}

    def load(self, state) -> None:
        """``state``: name -> (first moment, second moment, step count)."""
        for name, (m, v, t) in state.items():
            self.m[name], self.v[name], self.t[name] = m.clone(), v.clone(), t

    @torch.no_grad()
    def step(self, params, grads) -> None:
        for name, g in grads.items():
            if name not in self.first:
                self.first[name] = g.clone()
            p = params[name]
            if name not in self.m:
                self.m[name] = torch.zeros_like(p)
                self.v[name] = torch.zeros_like(p)
                self.t[name] = 0
            self.t[name] += 1
            t = self.t[name]
            self.m[name].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mhat = self.m[name] / (1 - self.b1 ** t)
            vhat = self.v[name] / (1 - self.b2 ** t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))


def make_params(specs, generator: torch.Generator, device) -> dict:
    """Leaves from ``specs`` [(name, shape, mean, std)]: every leaf with a
    std > 0 is mean + std * one slice of a single standard normal draw of
    all their elements (one call on ``device``), the others the constant
    ``mean``. f32."""
    n = sum(math.prod(s) for _, s, _, std in specs if std > 0)
    z = torch.randn(n, generator=generator, device=device, dtype=F32)
    out, at = {}, 0
    for name, shape, mean, std in specs:
        if std > 0:
            k = math.prod(shape)
            out[name] = z[at:at + k].reshape(shape) * std + mean
            at += k
        else:
            out[name] = torch.full(shape, float(mean), device=device,
                                   dtype=F32)
    return out
