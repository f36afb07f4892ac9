"""roofline.k3: K3's share of its roofline over the traced stretch
(``kernels/k3.py``, ``readers.roofline``)."""
from portbench.readers import roofline


def read(reading):
    return roofline(reading, "k3")
