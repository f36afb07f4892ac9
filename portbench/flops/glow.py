"""Model FLOPs of Glow on images, from the configuration's shapes.

A convolution is 2 x output pixels x Cout x Cin x k^2 and a matrix product
2 x m x n x k. Per image: each flow's 1x1 convolution (c x c) and its
coupling network (conv 3x3 c/2 -> f, conv 1x1 f -> f, ZeroConv 3x3 f ->
c/2) over the block's squeezed pixels, and each block's prior ZeroConv
(c/2 -> c, the last block's c -> 2c). Per forward, whatever the batch: the
K weights P (L + I) (U + D) of each block's 1x1 convolutions, two batched
c x c products. A train step is the forward, the weights' gradients and the
inputs' gradients, each as many operations as the forward, less the input
gradients nothing needs: the last block's prior (a ZeroConv of zeros) and
P's side of the PLU product (P is a buffer). Elementwise work is not
counted.
"""
from __future__ import annotations


def blocks(cfg: dict):
    """(channels after the squeeze, side after it, split) of each block."""
    out, ch, side = [], cfg["channels"], cfg["image_size"]
    for i in range(cfg["n_blocks"]):
        side //= 2
        out.append((ch * 4, side, i < cfg["n_blocks"] - 1))
        ch *= 2
    return out


def flow_ops(c: int, f: int, pixels: int) -> int:
    """One flow's operations over ``pixels``: the 1x1 convolution and the
    coupling network's three convolutions."""
    h = c // 2
    return 2 * pixels * (c * c + 9 * h * f + f * f + 9 * f * h)


def forward_terms(cfg: dict):
    """(per image, per forward, unneeded input gradients per image, per
    forward) FLOPs of one forward."""
    k, f = cfg["n_flows"], cfg["filter_size"]
    per_image = per_forward = unneeded = unneeded_fwd = 0
    for c, side, split in blocks(cfg):
        px = side * side
        prior = 2 * px * 9 * (c // 2 * c if split else c * 2 * c)
        per_image += k * flow_ops(c, f, px) + prior
        if not split:
            unneeded += prior
        per_forward += 2 * (2 * k * c ** 3)
        unneeded_fwd += 2 * k * c ** 3
    return per_image, per_forward, unneeded, unneeded_fwd


def forward_flops(cfg: dict, batch: int) -> float:
    per_image, per_forward, _, _ = forward_terms(cfg)
    return batch * per_image + per_forward


def step_flops(cfg: dict) -> float:
    """FLOPs of one train step of ``batch_size`` images."""
    b = cfg["batch_size"]
    per_image, per_forward, unneeded, unneeded_fwd = forward_terms(cfg)
    return 3 * (b * per_image + per_forward) - b * unneeded - unneeded_fwd
