"""K6: a Glow block's K flows (ActNorm, 1x1 convolution, additive
coupling) as one kernel a direction (``csrc/glow_flow_stack.cu``), in the
train step with ``flow_stack``: each block's forward that saves every
flow's input, and its backward, which walks the flows in reverse from
those inputs. Operations: per flow the algorithm's 1x1 convolution and the
coupling network's three convolutions over B h w pixels forward
(``flops/glow.flow_ops``), and 3 times that backward: the forward
recomputed from the saved input, then the inputs' and the weights'
gradients. Bytes: the forward reads x (f32) and the weights (compute
dtype, f32 vectors) and writes y and the saved inputs (f32); the backward
reads the saved inputs, the output's gradient and the weights in both
layouts, and writes the input's gradient and the weights' f32
gradients."""
import re

from portbench.flops.glow import blocks, flow_ops

PATTERN = re.compile(r"flow_stack_(fwd|bwd)")
UNIT = "step"


def launches(cfg: dict, batch: int):
    """[(operations, bytes, peak dtype)] of one train step."""
    fs = cfg.get("flow_stack")
    if not fs:
        return []
    bf16 = cfg["compute_dtype"] == "bfloat16"
    dtype, e = ("bf16", 2) if bf16 else ("tf32", 4)
    k, f = cfg["n_flows"], cfg["filter_size"]
    out = []
    for c, side, _ in blocks(cfg):
        if fs is not True and side * side > fs:
            continue
        h, px = c // 2, batch * side * side
        act = px * c * 4
        convs = k * (9 * h * f + f * f + 9 * f * h)
        vectors = k * (2 * c + c * c + 2 * f + 2 * h) * 4
        ops = k * flow_ops(c, f, px)
        out.append((ops, 2 * act + k * act + convs * e + vectors, dtype))
        out.append((3 * ops, k * act + 2 * act + 2 * convs * e + vectors
                    + convs * 4 + vectors, dtype))
    return out
