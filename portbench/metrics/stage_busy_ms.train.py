"""stage_busy_ms.train: the host's mean ms a staged chunk spends filling
its ring buffer (the native gather) and enqueueing its copy to the card
(counters ``stage.busy_s`` over ``stage.chunks``), over every chunk the run
staged: the set-up's first chunk and the window's, traced or not. The
gather's library is built with the staging, before its first chunk, so a
checkout's first run reads no compiler here."""
from portbench.program import counter_per


def read(reading):
    v = counter_per("stage.busy_s", "stage.chunks")
    return None if v is None else v * 1e3
