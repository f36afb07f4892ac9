"""The port's spans and counters (``vgd_tpu_torch/utils/trace.py``) on the
CPU: with no profiler a span is the shared no-op and records nothing; under
``torch.profiler`` the samplers' and the staging's spans land in the Chrome
trace, nested as the table says; spans change no output bit; the staging's
counters count every chunk and the samplers keep their least forward. The
step graph's replay and capture run only on a card
(``tests/test_torch_port_gpu.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vgd_tpu_torch.core.config import (DataConfig, DiffusionConfig,
                                       GlowConfig, RunConfig)
from vgd_tpu_torch.parallel.mesh import LOCAL
from vgd_tpu_torch.train import common
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.diffusion import DiffusionTrainer
from vgd_tpu_torch.train.glow import GlowTrainer
from vgd_tpu_torch.utils import trace
from vgd_tpu_torch.utils.prefetch import PinnedRing, stage_chunks

HW, B, T, STEPS = 16, 2, 20, 4


@pytest.fixture
def tables(monkeypatch):
    """An empty counter table for the test, the process's own put back
    after it."""
    monkeypatch.setattr(trace, "COUNTERS", type(trace.COUNTERS)())
    return trace


def _trainer():
    cfg = DiffusionConfig(
        data=DataConfig(image_size=(HW, HW), batch_size=B),
        run=RunConfig(compute_dtype="float32"), timesteps=T, base_ch=8,
        time_emb_dim=32)
    tr = DiffusionTrainer(cfg, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(3))
    return tr


def _xt():
    return torch.randn((B, HW, HW, 3), generator=torch.Generator()
                       .manual_seed(5))


def test_span_without_a_profiler_is_the_shared_no_op(tables, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(10 ** 4):
        s = trace.span("vgd.sample.forward")
        assert s is trace.NO_SPAN
        with s:
            pass
    assert not tables.COUNTERS


def test_timed_counts_without_a_profiler(tables, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.timed("vgd.stage.fill", "stage.busy_s"):
        torch.ones(64).sum()
    once = tables.COUNTERS["stage.busy_s"]
    with trace.timed("vgd.stage.fill", "stage.busy_s"):
        torch.ones(64).sum()
    assert 0 < once < tables.COUNTERS["stage.busy_s"]


def test_timed_least_keeps_the_fewest_seconds(tables):
    for pause in (0.05, 0.005, 0.03):
        with trace.timed("vgd.sample.forward", "sample.forward_min_s",
                         least=True):
            time.sleep(pause)
    assert 0.005 <= tables.COUNTERS["sample.forward_min_s"] < 0.03


def _events(prof, tmp_path):
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(child, parents):
    s, e = float(child["ts"]), float(child["ts"]) + float(child["dur"])
    return any(float(p["ts"]) <= s and e <= float(p["ts"]) + float(p["dur"])
               for p in parents)


def test_ddim_sample_spans_nest_in_the_trace(tables, tmp_path):
    tr = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.ddim_sample(_xt(), STEPS, eta=0.0)
    assert tables.COUNTERS["sample.forward_min_s"] > 0
    events = _events(prof, tmp_path)
    by = {n: [e for e in events if e["name"] == n] for n in
          ("vgd.sample.request", "vgd.sample.step", "vgd.sample.forward")}
    assert [len(v) for v in by.values()] == [1, STEPS, STEPS]
    assert all(_inside(e, by["vgd.sample.request"])
               for e in by["vgd.sample.step"])
    assert all(_inside(e, by["vgd.sample.step"])
               for e in by["vgd.sample.forward"])


def test_ancestral_sample_spans(tables, tmp_path):
    tr = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.ancestral_sample(_xt(), 2, torch.Generator().manual_seed(1))
    events = _events(prof, tmp_path)
    by = {n: [e for e in events if e["name"] == n] for n in
          ("vgd.sample.request", "vgd.sample.step", "vgd.sample.forward")}
    assert [len(v) for v in by.values()] == [1, 3, 3]
    assert all(_inside(e, by["vgd.sample.request"])
               for e in by["vgd.sample.step"])
    assert all(_inside(e, by["vgd.sample.step"])
               for e in by["vgd.sample.forward"])
    assert tables.COUNTERS["sample.forward_min_s"] > 0


def test_samplers_give_the_same_bits_traced(tables):
    tr = _trainer()
    plain = tr.ddim_sample(_xt(), STEPS, eta=0.5,
                           generator=torch.Generator().manual_seed(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = tr.ddim_sample(_xt(), STEPS, eta=0.5,
                                generator=torch.Generator().manual_seed(2))
    assert torch.equal(plain, traced)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["vgd.sample.forward"] == STEPS


def _epoch(rows: np.ndarray, traced: bool):
    """One epoch of a tiny DDPM through the port's epoch scan on the CPU:
    its parameters, loss sum and the names of the spans it recorded."""
    tr = _trainer()
    gen = torch.Generator().manual_seed(7)
    graph = common.StepGraph(
        lambda b: {"loss": tr.train_step(b, gen)}, tr, gen)
    staging = L._Staging(rows, B, LOCAL, "cpu", 3, L.SCAN_PREFETCH)
    steps = len(rows) // B
    sels = (np.arange(i * B, (i + 1) * B) for i in range(steps))
    prof = L._Profiler(RunConfig(), torch.device("cpu"), False)
    spans = collections.Counter()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            sums, count, _ = L._stream_epoch_scan(
                graph, staging.chunks(sels, steps), prof, 0)
        spans.update({e.key: e.count for e in p.key_averages()
                      if e.key.startswith("vgd.")})
    else:
        sums, count, _ = L._stream_epoch_scan(
            graph, staging.chunks(sels, steps), prof, 0)
    assert count == steps
    return {k: v.detach().clone() for k, v in
            tr.model.state_dict().items()}, sums, spans


def test_epoch_scan_gives_the_same_bits_traced(tables):
    rows = np.random.default_rng(0).integers(0, 256, (14, HW, HW, 3),
                                             dtype=np.uint8)
    params, sums, spans = _epoch(rows, False)
    assert not spans
    params_t, sums_t, spans = _epoch(rows, True)
    assert sums == sums_t
    assert all(torch.equal(params[k], params_t[k]) for k in params)
    assert spans["vgd.stage.fill"] == spans["vgd.stage.wait"] == 3
    # both epochs staged their 3 chunks of 3, 3 and 1 steps
    assert tables.COUNTERS["stage.chunks"] == 6


@pytest.mark.parametrize("n,per", [(7, 3), (6, 3), (2, 5), (1, 1), (0, 4)])
def test_stage_chunks_counts_chunks_and_bytes(tables, n, per):
    """Each chunk is counted once, and the chunks hold every staged
    byte."""
    rows, width = 3, 5
    data = np.arange(40 * width, dtype=np.uint8).reshape(40, width)
    ring = PinnedRing((per, rows, width), "cpu", slots=2)
    sels = [np.arange(i, i + rows) for i in range(n)]
    got = [c.clone() for c in stage_chunks(data, sels, ring)]
    assert sum(c.shape[0] for c in got) == n
    assert sum(c.nbytes for c in got) == n * rows * width
    if n:
        assert torch.equal(torch.cat(got), torch.from_numpy(
            np.stack([data[s] for s in sels])))
    assert tables.COUNTERS["stage.chunks"] == math.ceil(n / per)
    if n:
        assert tables.COUNTERS["stage.busy_s"] > 0
        assert tables.COUNTERS["stage.wait_s"] >= 0


def test_profiler_trace_of_a_scan_epoch_holds_the_staging(tables, tmp_path):
    """The loop's ``_Profiler`` (``--profile-dir``) over a scan epoch: the
    chunks staged while it traces are named in its Chrome trace."""
    run = dataclasses.replace(RunConfig(), profile_dir=str(tmp_path),
                              profile_steps=(0, 7))
    prof = L._Profiler(run, torch.device("cpu"))
    data = np.arange(8 * 2 * 3, dtype=np.uint8).reshape(8, 2, 3)
    staging = L._Staging(data, 2, LOCAL, "cpu", 2, L.SCAN_PREFETCH)

    class Graph:
        def run(self, chunk):
            chunk.float().sum()

        def read(self):
            return {}
    sels = (np.arange(i * 2, i * 2 + 2) for i in range(4))
    L._stream_epoch_scan(Graph(), staging.chunks(sels, 4), prof, 0)
    prof.close()
    with open(os.path.join(tmp_path, "trace_steps_0_7.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"vgd.stage.fill", "vgd.stage.wait"} <= names


GLOW_SPANS = ("vgd.glow.forward", "vgd.glow.backward", "vgd.glow.adam")


def _glow():
    """A tiny Glow trainer (K6's plain form) after its ActNorm init, a
    batch and the run's generator."""
    cfg = GlowConfig(
        data=DataConfig(image_size=(HW, HW), batch_size=B, normalize=False),
        run=RunConfig(compute_dtype="float32"), n_flows=2, n_blocks=2,
        filter_size=16, flow_stack=True)
    tr = GlowTrainer(cfg, (HW, HW, 3), device="cpu")
    gen = torch.Generator().manual_seed(3)
    tr.init(gen)
    batch = torch.randint(0, 256, (B, HW, HW, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    tr.init_step(batch, gen)
    return tr, batch, gen


def test_glow_step_spans_nest_in_the_trace(tables, tmp_path):
    """Under a profiler a step opens ``vgd.glow.step`` once, around its
    forward, backward and Adam spans; the init's span fired before; the
    traced step gives the untraced one's bits."""
    tr, batch, gen = _glow()
    assert tables.COUNTERS["glow.init_s"] > 0
    twin, _, twin_gen = _glow()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = tr.train_step(batch, gen)
    assert tables.COUNTERS["glow.steps"] == 1
    events = _events(prof, tmp_path)
    step = [e for e in events if e["name"] == "vgd.glow.step"]
    assert len(step) == 1
    for name in GLOW_SPANS:
        inner = [e for e in events if e["name"] == name]
        assert len(inner) == 1 and _inside(inner[0], step), name
    assert float(twin.train_step(batch, twin_gen)["loss"]) == float(
        m["loss"])
    for (k, a), b in zip(tr.model.state_dict().items(),
                         twin.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_glow_step_without_a_profiler_counts_and_enters_no_span(
        tables, monkeypatch):
    tr, batch, gen = _glow()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(2):
        tr.train_step(batch, gen)
    assert tables.COUNTERS["glow.steps"] == 2
    assert 0 < tables.COUNTERS["glow.step_min_s"] < 10
