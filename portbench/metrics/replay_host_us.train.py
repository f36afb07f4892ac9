"""replay_host_us.train: the host's least us for one step graph replay (the
counter ``graph.replay_min_s``: the input slot's copy, the replay's
enqueue and the launch bookkeeping) over every replay of the run, traced
or not. That is the host's own cost, read where the launch queue had
room, after the card drained (the first replay, each epoch's start); a
replay behind a full queue waits a step of device time, so a mean would
read the step. None on the CPU, where no step is replayed."""
from portbench.program import counter


def read(reading):
    s = counter("graph.replay_min_s")
    return None if s is None else s * 1e6
