"""mfu.sample: the model FLOPs of the traced requests (``steps`` UNet
forwards of ``images`` each, ``flops/<family>.py`` ``request_flops``) over
the traced window, in % of the card's bf16 peak."""
from portbench.readers import mfu


def read(reading):
    t = reading.cell.traffic
    return mfu(reading, reading.flops().request_flops(
        reading.cell.config, t["steps"], t["images"]), "request")
