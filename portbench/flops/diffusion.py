"""Model FLOPs of the DDPM UNet, from the configuration's shapes.

A convolution is 2 x output pixels x Cout x Cin x k^2, a Dense layer 2 x
rows x in x out, an attention 4 x N x M x D (q k^T and p v). The learned
tokens' k | v projection runs once a forward, whatever the batch. A train
step is the forward, the weights' gradients and the inputs' gradients,
each as many operations as the forward, less the input gradients nothing
needs: those of the first block's two convolutions (the noised image) and
of the first time-MLP layer (the sinusoidal embedding). A sampling request
is ``steps`` forwards. Elementwise work is not counted.
"""
from __future__ import annotations

TOKENS, TOKEN_DIM = 64, 256


def _blocks(c):
    # (name, in, out, resolution divisor)
    return [("down1", 3, c, 1), ("down2", c, 2 * c, 2),
            ("down3", 2 * c, 4 * c, 4), ("bottleneck", 4 * c, 4 * c, 8),
            ("up3", 8 * c, 2 * c, 4), ("up2", 4 * c, c, 2),
            ("up1", 2 * c, c, 1)]


def forward_terms(cfg: dict):
    """(per image, per forward, first-input terms per image) FLOPs of one
    forward: the batch-proportional part, the part run once a forward (the
    tokens' projection) and the part whose input gradient no step needs."""
    c, d, size = cfg["base_ch"], cfg["time_emb_dim"], cfg["image_size"]
    per_image = 2 * d * 4 * d * 2
    first = 2 * d * 4 * d
    for name, i, o, div in _blocks(c):
        px = (size // div) ** 2
        block = 2 * px * o * i * 9 + 2 * d * o + 2 * px * o * o * 9
        if i != o:
            block += 2 * px * o * i
        if name == "down1":
            first += 2 * px * o * i * 9 + (2 * px * o * i if i != o else 0)
        per_image += block
    per_forward = 0
    if cfg["attention"]:
        for dim, div in ((2 * c, 2), (4 * c, 4)):
            px = (size // div) ** 2
            per_image += (2 * px * dim * TOKEN_DIM * 2
                          + 4 * px * TOKENS * TOKEN_DIM)
            per_forward += 2 * TOKENS * TOKEN_DIM * 2 * TOKEN_DIM
        n, ch = (size // 8) ** 2, 4 * c
        per_image += 2 * n * 3 * ch * ch + 4 * n * n * ch + 2 * n * ch * ch
    per_image += 2 * size * size * 3 * c
    return per_image, per_forward, first


def forward_flops(cfg: dict, batch: int) -> float:
    per_image, per_forward, _ = forward_terms(cfg)
    return batch * per_image + per_forward


def step_flops(cfg: dict) -> float:
    """FLOPs of one train step of ``batch_size`` images."""
    b = cfg["batch_size"]
    per_image, per_forward, first = forward_terms(cfg)
    return 3 * (b * per_image + per_forward) - b * first


def request_flops(cfg: dict, steps: int, images: int) -> float:
    """FLOPs of one sampling request: ``steps`` forwards of ``images``."""
    return steps * forward_flops(cfg, images)
