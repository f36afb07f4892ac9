"""device_idle.sample: 1 - the union of the device's kernel, copy and fill
intervals over the traced window, in %."""
from portbench.readers import idle


def read(reading):
    return idle(reading)
