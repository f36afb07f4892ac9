"""stage_wait_ms.train: the host's mean ms a staged chunk waits for its
ring buffer's last copy to the card to complete before refilling it
(counters ``stage.wait_s`` over ``stage.chunks``), over every chunk the run
staged: the set-up's first chunk and the window's, traced or not."""
from portbench.program import counter_per


def read(reading):
    v = counter_per("stage.wait_s", "stage.chunks")
    return None if v is None else v * 1e3
