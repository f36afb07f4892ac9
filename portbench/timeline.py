"""A traced stretch of a run's window (``torch.profiler``, CPU and CUDA
activities) reduced to what the per-layer readers and the ``breakdown``
need: the device's operations, the window's length, the union of the
device's busy intervals, and the idle gaps named by what the host was
doing.

The trace is exported as a Chrome trace into ``TMPDIR``, read once and
deleted. All times are in the trace's own clock (microseconds), so the
window is the ``portbench.window`` span that ``Traced`` records around the
traced calls.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Optional

import torch

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# a device gap shorter than this is a launch's own latency inside a stream
# of work; longer ones are named by the host activity around them
SHORT_GAP_US = 10.0
TOP = 10


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start: float
    dur: float


class Timeline(NamedTuple):
    """A traced stretch: ``ops`` the device operations inside the window,
    ``window_s`` its length, ``busy_s`` the union of the device's
    operations, ``units`` the steps, forwards or requests it holds, and
    the ``breakdown`` of the result line."""
    ops: List[DeviceOp]
    window_s: float
    busy_s: float
    units: Dict[str, int]
    breakdown: dict

    def kernels(self, pattern=None) -> List[DeviceOp]:
        """The kernels inside the window, those whose name matches the
        compiled ``pattern`` where one is given."""
        return [o for o in self.ops if o.cat == "kernel" and (
            pattern is None or pattern.search(o.name))]


def _union(intervals):
    """Merged [start, end) of ``intervals``, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(host, starts, t):
    """The innermost host activity running at time ``t`` (its name), or
    None."""
    best = None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4000), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return None if best is None else best[2]


def reduce(events: list, units: Dict[str, int]) -> Timeline:
    """The ``Timeline`` of a Chrome trace's events."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = min(float(e["ts"]) for e in win)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        # an operation belongs to the window where it starts in it: the
        # device's timestamps are mapped onto the host's clock, which can
        # put the last end past the span's close
        if cat in DEVICE_CATS and w0 <= s <= w1:
            ops.append(DeviceOp(e.get("name", ""), cat, s, d))
        elif cat in HOST_CATS and e.get("name") != WINDOW_SPAN:
            host.append((s, s + d, e.get("name", "")))
    busy = _union((o.start, min(o.start + o.dur, w1)) for o in ops)
    busy_us = sum(e - s for s, e in busy)
    host.sort()
    starts = [h[0] for h in host]
    gaps, edges = collections.Counter(), [w0] + [
        x for iv in busy for x in iv] + [w1]
    counts = collections.Counter()
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        if e - s < SHORT_GAP_US:
            name = f"device gaps under {SHORT_GAP_US:g} us (launch latency)"
        else:
            name = _host_at(host, starts, (s + e) / 2) or "host outside ops"
        gaps[name] += (e - s) / 1e6
        counts[name] += 1
    by_op = collections.Counter()
    for o in ops:
        by_op[o.name[:160]] += o.dur / 1e6
    breakdown = {
        "device_ops": [[n, s] for n, s in by_op.most_common(TOP)],
        "idle_gaps": [[f"{n} (x{counts[n]})", s]
                      for n, s in gaps.most_common(TOP)]}
    return Timeline(ops, (w1 - w0) / 1e6, busy_us / 1e6, dict(units),
                    breakdown)


class Traced:
    """``with Traced(device) as tr: ...`` profiles the block, which starts
    and ends with the device drained; ``tr.timeline(units)`` exports and
    reduces the trace afterwards."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: Optional[list] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def timeline(self, units: Dict[str, int]) -> Timeline:
        """The traced stretch reduced (the trace is exported and read here,
        after the run's window)."""
        if self.events is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = json.load(f).get("traceEvents", [])
            finally:
                os.remove(path)
            del self.prof
        return reduce(self.events, units)
