"""roofline.k4: K4's share of its roofline over the traced stretch
(``kernels/k4.py``, ``readers.roofline``)."""
from portbench.readers import roofline


def read(reading):
    return roofline(reading, "k4")
