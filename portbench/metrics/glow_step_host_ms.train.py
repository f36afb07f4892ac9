"""glow_step_host_ms.train: the host's least ms for one Glow train step's
enqueue (the counter ``glow.step_min_s``: the dequantisation, forward,
backward and Adam launches of ``GlowTrainer.train_step``) over every step
of the run, the set-up's checked steps included, traced or not: the
host's own cost, read where the launch queue had room. At or above the
card's time a step, the per-step loop is host-bound; below it, the host
can keep ahead."""
from portbench.program import counter


def read(reading):
    s = counter("glow.step_min_s")
    return None if s is None else s * 1e3
