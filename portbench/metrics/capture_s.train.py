"""capture_s.train: the host seconds a step graph's capture takes until it
returns (counters ``graph.capture_s`` over ``graph.captures``; the capture
runs in set-up, after the eager warm-up steps); None on the CPU, where
nothing is captured."""
from portbench.program import counter_per


def read(reading):
    return counter_per("graph.capture_s", "graph.captures")
