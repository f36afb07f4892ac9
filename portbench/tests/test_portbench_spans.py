"""The readers of the program's own counters (``program.py``,
``metrics/``) over traced tiny runs of each cell on the CPU: each returns
a positive number or None, as its docstring says. On the CPU no step is
replayed and nothing is captured, so the step graph's readers read None;
the staging's counters and the sampler's least forward hold numbers, and
the sampler's spans name the traced forwards inside their steps."""
import dataclasses
import sys
import time

import pytest
import torch

import vgd_tpu_torch.utils
from portbench import harness, timeline
from portbench.tests.test_portbench_runs import SEED, TINY, tiny
from portbench.timeline import reduce
from vgd_tpu_torch.utils import trace

NEW = {"replay_host_us.train", "stage_busy_ms.train", "stage_wait_ms.train",
       "capture_s.train", "capture_pool_gb.train", "forward_host_ms.sample"}
ON_THE_CPU = {"stage_busy_ms.train", "stage_wait_ms.train",
              "forward_host_ms.sample"}


def traced_line(name, monkeypatch):
    """A traced tiny run's cell, result line and traced events. A sample
    run traces its first request, which the window always holds, however
    slow the host."""
    events = []

    def keep(evs, units):
        events.extend(evs)
        return reduce(evs, units)
    monkeypatch.setattr(timeline, "reduce", keep)
    trace.COUNTERS.clear()
    cell = tiny(name)
    if "trace_from" in cell.traffic:
        cell = dataclasses.replace(cell, traffic={
            **cell.traffic, "trace_from": 0, "trace_requests": 1})
    out = harness.run_cell(cell, SEED, 1.0, True, torch.device("cpu"),
                           time.perf_counter())
    return cell, harness.result_line(cell, out, True, {}, None)[0], events


def _spans(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("name") == name
            and e.get("cat") == "user_annotation" and e.get("ph") == "X"]


@pytest.mark.parametrize("name", list(TINY))
def test_traced_run_reports_the_new_metrics(name, monkeypatch):
    cell, line, events = traced_line(name, monkeypatch)
    listed = {m["name"] for m in cell.per_layer} & NEW
    assert listed
    for m in listed:
        if m in ON_THE_CPU:
            assert line["metrics"][m]["value"] > 0, m
        else:
            assert m not in line["metrics"], m
    if name.endswith(".train"):
        assert trace.COUNTERS["stage.chunks"] >= 1
        assert "graph.captures" not in trace.COUNTERS
    else:
        # the traced forwards are named, each inside its step's span
        steps = cell.traffic["steps"] * cell.traffic["trace_requests"]
        forwards = _spans(events, "vgd.sample.forward")
        within = _spans(events, "vgd.sample.step")
        assert len(forwards) == len(within) == steps
        assert all(any(s <= f0 and f1 <= e for s, e in within)
                   for f0, f1 in forwards)


def test_readers_read_none_without_the_program_tables(monkeypatch):
    """Where the program has no trace module (an older checkout) or its
    counters are empty, every new reader returns None."""
    cell = harness.find_cell("ddpm256.train")
    reading = harness.Reading(cell, None, None)
    monkeypatch.setattr(trace, "COUNTERS", type(trace.COUNTERS)())
    for m in NEW:
        reader = harness.load_module(f"{harness.BENCH}/metrics/{m}.py")
        assert reader.read(reading) is None, m
    monkeypatch.setitem(sys.modules, "vgd_tpu_torch.utils.trace", None)
    monkeypatch.delattr(vgd_tpu_torch.utils, "trace")
    for m in NEW:
        reader = harness.load_module(f"{harness.BENCH}/metrics/{m}.py")
        assert reader.read(reading) is None, m
