"""forward_host_ms.sample: the host's least ms for one fused UNet forward
of a sampler (the counter ``sample.forward_min_s``: the forward's
launches) over every forward of the run, the warm-up request's included,
traced or not: the host's own cost, read where the launch queue had room
(each request's first forward, after the last one's images reached the
host). At or above the card's time a forward, the sampler is host-bound;
below it, the host can keep ahead."""
from portbench.program import counter


def read(reading):
    s = counter("sample.forward_min_s")
    return None if s is None else s * 1e3
