"""What the readers of the program's own counters share: the table
``COUNTERS`` of ``vgd_tpu_torch.utils.trace``, read in the run's process
after the run. It holds every event since the process started, set-up
included, timed on the host's clock whether or not the profiler was on. A
program without that module has nothing to read: each function returns
None then, as it does where the counter never fired, never 0."""
from __future__ import annotations


def _counters():
    try:
        from vgd_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.COUNTERS


def counter(name: str):
    """``COUNTERS[name]``."""
    c = _counters()
    return None if c is None else c.get(name) or None


def counter_per(total: str, count: str):
    """``COUNTERS[total]`` over ``COUNTERS[count]``."""
    c = _counters()
    if c is None or not c.get(count):
        return None
    return c.get(total, 0) / c[count]
