"""mfu.train: the model FLOPs of the traced train steps (``flops/<family>.py``
``step_flops``) over the traced window, in % of the card's bf16 peak."""
from portbench.readers import mfu


def read(reading):
    return mfu(reading, reading.flops().step_flops(reading.cell.config),
               "step")
