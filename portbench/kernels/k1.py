"""K1: the fused Conv 4x4 stride 2 + batch statistics forward
(``csrc/conv_bn_stats.cu``), in the VAE-GAN train step with
``fused_conv``: every encoder layer (padding 0) of the step's two encoder
forwards, and every discriminator stage after the first (padding 1) of its
2 x ``d_steps`` + 1 forwards. A launch reads x and w once in the compute
dtype and writes the f32 conv output and the per-channel mean and
variance."""
import re

PATTERN = re.compile(r"(conv_stats|combine_stats)\w*_kernel")
UNIT = "step"
ENC_CHANNELS = (32, 64, 128, 256)


def _launch(b, h, cin, cout, pad, dtype):
    ho = (h + 2 * pad - 4) // 2 + 1
    e = 2 if dtype == "bf16" else 4
    ops = 2 * b * ho * ho * cout * cin * 16
    nbytes = (b * h * h * cin + cout * cin * 16) * e + \
        (b * ho * ho * cout + 2 * cout) * 4
    return ops, nbytes, dtype


def launches(cfg: dict, batch: int):
    """[(operations, bytes, peak dtype)] of one train step."""
    if not cfg.get("fused_conv"):
        return []
    dtype = "bf16" if cfg["compute_dtype"] == "bfloat16" else "tf32"
    enc, h, cin = [], cfg["image_size"], cfg["channels"]
    for cout in ENC_CHANNELS:
        enc.append(_launch(batch, h, cin, cout, 0, dtype))
        h, cin = (h - 4) // 2 + 1, cout
    disc, h, n = [], cfg["image_size"] // 2, cfg["ndf"] // 4
    while h > 4:
        disc.append(_launch(batch, h, n, 2 * n, 1, dtype))
        h, n = h // 2, 2 * n
    return 2 * enc + (2 * cfg["d_steps"] + 1) * disc
