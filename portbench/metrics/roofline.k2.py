"""roofline.k2: K2's share of its roofline over the traced stretch
(``kernels/k2.py``, ``readers.roofline``)."""
from portbench.readers import roofline


def read(reading):
    return roofline(reading, "k2")
