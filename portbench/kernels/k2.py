"""K2: the differentiable attention of the DDPM train step
(``csrc/flash_attention.cu`` forward with the row logsumexp,
``csrc/flash_attention_bwd.cu`` dq, dk/dv and their split sum), f32
operands, at the UNet's three attention sites where N x M reaches the
program's documented gate of 2^18: the two cross attentions (N pixels, M =
64 tokens, D = 256) and the bottleneck's self-attention (N = M pixels, D =
4 base_ch). Operations: 4 B N M D forward, 2.5 times that backward
(FlashAttention-2's count, no recomputation). Bytes: the forward reads q,
k, v and writes o and the logsumexp; the backward reads q, k, v, do, the
logsumexp and delta and writes dq, dk, dv."""
import re

PATTERN = re.compile(r"flash_fwd_kernel|flash_bwd_dq_kernel|"
                     r"flash_bwd_dkv_kernel|sum_splits_kernel")
UNIT = "step"
GATE = 1 << 18
TOKENS, TOKEN_DIM = 64, 256


def sites(cfg: dict):
    """(N, M, D) of each attention of one UNet forward."""
    if not cfg["attention"]:
        return []
    s, c = cfg["image_size"], cfg["base_ch"]
    return [((s // 2) ** 2, TOKENS, TOKEN_DIM),
            ((s // 4) ** 2, TOKENS, TOKEN_DIM),
            ((s // 8) ** 2, (s // 8) ** 2, 4 * c)]


def launches(cfg: dict, batch: int):
    out = []
    for n, m, d in sites(cfg):
        if n * m < GATE:
            continue
        b = batch
        fwd = 4 * b * n * m * d
        out.append((fwd, 4 * (2 * b * n * d + 2 * b * m * d + b * n),
                    "tf32"))
        out.append((2.5 * fwd, 4 * (3 * b * n * d + 4 * b * m * d
                                    + 2 * b * n), "tf32"))
    return out
