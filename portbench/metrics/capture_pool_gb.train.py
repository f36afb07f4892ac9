"""capture_pool_gb.train: the device memory (10^9 B) the caching allocator
reserved during a step graph's capture, the graph's private pool, which
its replays reuse (counters ``graph.capture_reserved_bytes`` over
``graph.captures``); None on the CPU, where nothing is captured."""
from portbench.program import counter_per


def read(reading):
    v = counter_per("graph.capture_reserved_bytes", "graph.captures")
    return None if v is None else v / 1e9
