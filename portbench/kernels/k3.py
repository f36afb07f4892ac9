"""K3: the inference attention of the fused sampling UNet
(``csrc/flash_attention.cu``), f32 operands, at all three attention sites
of a forward (no size gate on the fused path). Operations 4 B N M D;
bytes: q, k, v read once, o written once."""
import os
import re

from portbench.harness import load_module

sites = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "k2.py")).sites

PATTERN = re.compile(r"flash_fwd_kernel")
UNIT = "forward"


def launches(cfg: dict, batch: int):
    b = batch
    return [(4 * b * n * m * d, 4 * (2 * b * n * d + 2 * b * m * d), "tf32")
            for n, m, d in sites(cfg)]
