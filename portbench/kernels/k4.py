"""K4: GroupNorm(8) + SiLU of the fused sampling UNet
(``csrc/groupnorm_silu.cu``), in the main path's forms: two a ConvBlock,
on the conv output in the compute dtype, the first cast to it, the second
with the block's residual added before the cast. The residual is a 1x1
conv's output (compute dtype) where the block changes the width, else the
block's input: the bottleneck's is f32 with attention (the cross
attention's output), the compute dtype without. Bytes only: x and the
residual read once, y written once."""
import re

PATTERN = re.compile(r"groupnorm_silu_kernel")
UNIT = "forward"


def launches(cfg: dict, batch: int):
    s, c = cfg["image_size"], cfg["base_ch"]
    e = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    blocks = [(3, c, 1), (c, 2 * c, 2), (2 * c, 4 * c, 4),
              (4 * c, 4 * c, 8), (8 * c, 2 * c, 4), (4 * c, c, 2),
              (2 * c, c, 1)]
    out = []
    for cin, cout, div in blocks:
        n = batch * (s // div) ** 2 * cout
        res = e
        if cin == cout and cfg["attention"]:
            res = 4
        out.append((0, n * 2 * e, "bf16"))
        out.append((0, n * (2 * e + res), "bf16"))
    return out
