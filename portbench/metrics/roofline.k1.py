"""roofline.k1: K1's share of its roofline over the traced stretch
(``kernels/k1.py``, ``readers.roofline``)."""
from portbench.readers import roofline


def read(reading):
    return roofline(reading, "k1")
