"""roofline.k6: K6's share of its roofline over the traced stretch
(``kernels/k6.py``, ``readers.roofline``)."""
from portbench.readers import roofline


def read(reading):
    return roofline(reading, "k6")
