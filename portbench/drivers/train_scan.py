"""Training through the epoch scan, as ``train.loop.run_vaegan`` and
``run_diffusion`` run it: shuffled epochs of the train split staged in
chunks by the run's ``_Staging`` and run by the run's ``StepGraph``, one
CUDA-graph replay a step after two eager steps and a capture.

Set-up (counted in ``setup_s``): the rows (uniform uint8 pixels drawn on
the card from the run's data seed, copied to host memory), the weights
(the reference's leaves from the weights seed), the program's trainer,
loader, staging and step graph, and the first ``check_steps`` steps of
epoch 0, each through ``StepGraph.run`` on the first staged chunk, read
one by one: two eager warm-up steps, then the capture and the first
replay. The window then runs each epoch through the program's own
``train.loop._stream_epoch_scan``: the rest of that chunk and the chunks
after it (the KL ramp filled before each epoch, the step graph's sums
read at each epoch's end, as the loop does; validation, checkpoints and
grids stay out), until the first chunk boundary past ``--seconds``, and
ends at a ``torch.cuda.synchronize()``.

``train_images_per_s`` is every image of every step the window ran over
the window's whole time. With ``--trace 1`` the profiler traces
``trace_steps`` steps of the first full chunk of the window, from a
drained device to a drained device.

The check: the reference runs the same first steps from the same weights,
rows (the rule of the traffic file) and draws (the program's seed), in
f32, and the last of them once more from the program's own state before
it; ``compare`` gives the gaps.
"""
from __future__ import annotations

import gc
import itertools
import math
import time
from typing import Optional

import numpy as np
import torch

from portbench import compare
from portbench.compare import Forced, Readings
from portbench.harness import Check, Outcome, program_seed, seed_of
from portbench.reference.ops import (PRECISIONS, Adam, exact, exact_f32,
                                     make_params)
from portbench.timeline import Traced

CHUNK_BYTES = 256 << 20


def make_rows(cfg: dict, seed: int, device) -> np.ndarray:
    """``dataset_size`` uniform uint8 images (N, H, W, C) in host memory,
    drawn on ``device`` in chunks from the run's data seed."""
    s, c, n = cfg["image_size"], cfg["channels"], cfg["dataset_size"]
    g = torch.Generator(device=device).manual_seed(seed_of(seed, "data"))
    host = torch.empty((n, s, s, c), dtype=torch.uint8)
    per = max(1, CHUNK_BYTES // (s * s * c))
    for i in range(0, n, per):
        m = min(per, n - i)
        host[i:i + m].copy_(torch.randint(0, 256, (m, s, s, c),
                                          dtype=torch.uint8, device=device,
                                          generator=g))
    return host.numpy()


def make_weights(ref, cfg: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(seed_of(seed, "weights"))
    return make_params(ref.param_specs(cfg), g, device)


def epoch_selections(cfg: dict, seed: int, epoch: int):
    """The traffic's batches of an epoch, independently of the program:
    the train split is the first round(train_fraction * rows) of numpy's
    default_rng(seed) permutation of the rows, an epoch is
    default_rng(seed + epoch)'s permutation of the split cut into
    consecutive batches, each batch's indices sorted."""
    n = cfg["dataset_size"]
    split = np.random.default_rng(seed).permutation(n)[
        :int(round(cfg["train_fraction"] * n))]
    order = np.random.default_rng(seed + epoch).permutation(split)
    b = cfg["batch_size"]
    return [np.sort(order[i * b:(i + 1) * b]) for i in range(len(order) // b)]


class Run:
    """The program's objects of one run and the readings of its first
    steps."""

    def __init__(self, ctx):
        from vgd_tpu_torch.data.celeba import ArrayDataset, Loader, \
            split_dataset
        from vgd_tpu_torch.parallel.mesh import LOCAL
        from vgd_tpu_torch.train.common import StepGraph
        from vgd_tpu_torch.train.loop import _Profiler, _staging

        cell, dev, seed = ctx.cell, ctx.device, ctx.seed
        self.ctx, self.cfg = ctx, cell.config
        self.seed = program_seed(seed)
        self.ref = cell.module("reference")
        ctx.mark("imports")
        self.rows = make_rows(self.cfg, seed, dev)
        ctx.mark("rows")
        self.params0 = make_weights(self.ref, self.cfg, seed, dev)
        ctx.mark("weights")
        ds = ArrayDataset(self.rows)
        tr_idx, _ = split_dataset(ds, self.cfg["train_fraction"], self.seed)
        self.loader = Loader(ds, tr_idx, self.cfg["batch_size"], shuffle=True,
                             seed=self.seed)
        self.steps = len(self.loader)
        self.system = cell.module("families").TrainSystem(
            self.cfg, ds.image_shape, self.params0, self.seed, dev)
        ctx.mark("trainer")
        self.staging = _staging(self.loader, LOCAL, dev, True, self.steps)
        ctx.mark("staging")
        self.graph = StepGraph(self.system.step_fn, self.system.trainer,
                               self.system.generator)
        # the loop's profiler, off as in a run without --profile-dir
        self.prof = _Profiler(self.system.trainer.cfg.run, dev, False)
        self.epoch = self.gstep = 0
        ctx.mark("step graph")

    def chunks(self):
        """Device chunks of the next epoch, staged as the loop stages
        them."""
        self.system.start_epoch(self.epoch)
        sels = (sel for sel, _ in self.loader.selections())
        return self.staging.chunks(sels, self.steps)

    def adam_state(self) -> dict:
        """By leaf: (parameter, first moment, second moment, Adam count),
        on the host."""
        names = {id(p): n for n, p in self.system.leaves().items()}
        out = {}
        for opt in self.system.optimizers():
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state.get(p, {})
                    zero = torch.zeros_like(p)
                    out[names[id(p)]] = (
                        _host1(p), _host1(st.get("exp_avg", zero)),
                        _host1(st.get("exp_avg_sq", zero)),
                        int(st["step"]) if "step" in st else 0)
        return out

    def first_steps(self, k: int):
        """Steps 1..k of epoch 0 on the first chunk, read one by one; the
        chunk iterator and the rest of the chunk. Keeps the readings on
        the host (``compare.Readings``): the batch each step consumed
        (its input tensor after the step: on a card the step graph's input
        slot from step 3 on), each leaf's first gradient (a pre-step hook
        on each of the trainer's optimizers during step 1, an eager step),
        the state after step 1 and around step k, the first replay."""
        chunks = self.chunks()
        cur = next(chunks)
        names = {id(p): n for n, p in self.system.leaves().items()}
        first = {}

        def grab(opt, args, kwargs):
            for group in opt.param_groups:
                for p in group["params"]:
                    if names[id(p)] not in first and p.grad is not None:
                        first[names[id(p)]] = _host1(p.grad)
        hooks = [opt.register_step_pre_hook(grab)
                 for opt in self.system.optimizers()]
        losses, batches = [], []
        for i in range(k):
            if i == k - 1:
                before = self.adam_state()
            self.graph.run(cur[i:i + 1])
            losses.append(self.graph.read())
            batches.append(self.system.seen.to("cpu", copy=True))
            if i == 0:
                for h in hooks:
                    h.remove()
                one = self.adam_state()
        after = {n: (s[0], s[1], s[3]) for n, s in self.adam_state().items()}
        change = _host({n: p.detach() - self.params0[n]
                        for n, p in self.system.leaves().items()})
        self.readings = Readings(
            losses, batches, first, {n: s[1] for n, s in one.items()},
            {n: s[0] for n, s in one.items()}, change, before, after)
        self.gstep = k
        self.ctx.mark("first steps")
        return chunks, cur[k:]

    def free(self) -> None:
        """Drop the program's state (the reference runs after it)."""
        for name in ("graph", "staging", "system", "loader", "prof"):
            setattr(self, name, None)
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def _host1(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def _host(tensors) -> dict:
    return {k: _host1(v) for k, v in tensors.items()}


def _batches(run: Run, k: int):
    sels = epoch_selections(run.cfg, run.seed, 0)[:k]
    return [torch.from_numpy(run.rows[s]).to(run.ctx.device) for s in sels]


def reference_readings(run: Run, precision: str = "float32") -> Readings:
    """The reference's readings over the checked steps, as
    ``Run.first_steps`` keeps the program's, on the run's weights, rows and
    draws."""
    ctx, cfg, ref = run.ctx, run.cfg, run.ref
    exact_f32()
    k = ctx.cell.traffic["check_steps"]
    params = {n: v.clone() for n, v in run.params0.items()}
    kept = {}

    def tap(i, adam):
        if i == 0:
            kept["moments"] = _host(adam.m)
            kept["params1"] = {n: _host1(params[n]) for n in adam.m}
        if i == k - 2:
            kept["before"] = {n: (_host1(params[n]), _host1(adam.m[n]),
                                  _host1(adam.v[n]), adam.t[n])
                              for n in adam.m}
        if i == k - 1:
            kept["after"] = {n: (_host1(params[n]), _host1(adam.m[n]),
                                 adam.t[n]) for n in adam.m}
            kept["first"] = _host(adam.first)
    g = torch.Generator(device=ctx.device).manual_seed(run.seed)
    batches = _batches(run, k)
    losses = ref.train_steps(params, batches, g, cfg, PRECISIONS[precision],
                             tap=tap)
    change = _host({n: params[n] - run.params0[n] for n in kept["moments"]})
    return Readings(losses, [b.cpu() for b in batches], kept["first"],
                    kept["moments"], kept["params1"], change, kept["before"],
                    kept["after"])


def reference_step(run: Run, step: int, start: dict, taken: dict,
                   overrides: dict) -> Adam:
    """The reference's step ``step`` (from 1) in f32 from ``start`` (by
    leaf: parameter, moments and Adam count), with the leaves ``taken`` in
    place and the configuration's ``overrides``, on the batch and draws
    that the traffic and the run's seed give that step; its Adam."""
    ctx, cfg, ref = run.ctx, run.cfg, run.ref
    dev = ctx.device
    exact_f32()
    g = torch.Generator(device=dev).manual_seed(run.seed)
    for _ in range(step - 1):
        ref.draws(g, cfg, cfg["batch_size"], dev)
    params = {n: v.clone() for n, v in run.params0.items()}
    params.update({n: s[0].to(dev, copy=True) for n, s in start.items()})
    params.update({n: p.to(dev, copy=True) for n, p in taken.items()})
    adam = Adam(cfg["lr"])
    adam.load({n: (m.to(dev), v.to(dev), t)
               for n, (_, m, v, t) in start.items() if t})
    ref.train_steps(params, _batches(run, step)[-1:], g,
                    {**cfg, **overrides}, exact, adam=adam)
    return adam


def wanted(run: Run, prog: Readings, ref: Readings) -> dict:
    """By group: the reference's first gradients and its step
    ``check_steps`` from ``prog``'s state before it (``compare.Forced``);
    a group in the reference's ``FORCED`` takes its leaves from ``prog``'s
    state after step 1 and after step ``check_steps``."""
    k = run.ctx.cell.traffic["check_steps"]
    out = {}
    for group in run.ref.GROUPS:
        overrides, prefixes = run.ref.FORCED.get(group, ({}, ()))
        first, taken = ref.first, {}
        if prefixes:
            first = _host(reference_step(
                run, 1, {}, {n: p for n, p in prog.params1.items()
                             if n.startswith(prefixes)}, overrides).first)
            taken = {n: s[0] for n, s in prog.after.items()
                     if n.startswith(prefixes)}
        adam = reference_step(run, k, prog.before, taken, overrides)
        wrote = {n: adam.m[n] - adam.b1 ** (adam.t[n] - prog.before[n][3])
                 * prog.before[n][1].to(adam.m[n].device) for n in adam.m
                 if n in prog.before}
        out[group] = (first, Forced(_host(adam.m), dict(adam.t),
                                    _host(wrote)))
    return out


def gaps(run: Run, readings: Readings, ref: Readings) -> dict:
    """``compare.train_gaps`` of ``readings`` (the program's, or the
    reference's in its place) against the reference."""
    return compare.train_gaps(readings, ref, wanted(run, readings, ref),
                              run.ref.GROUPS)


def checks(run: Run, ref_readings: Readings, limits: dict):
    """The compared numbers of the program's readings against the
    reference's (``compare``)."""
    got = gaps(run, run.readings, ref_readings)
    run.ctx.log(", ".join(f"{k} {v:.6g}" if isinstance(v, float) else
                          f"{k} {v}" for k, v in got.items()))
    return [Check(name, got[name], limits[name]) for name in limits]


def _finite(sums: dict) -> bool:
    return all(math.isfinite(v) for v in sums.values())


class Window:
    """The chunks that the window feeds ``_stream_epoch_scan``: those of an
    epoch until the first chunk boundary past ``seconds`` (``closed`` is
    set then), staging named by a ``portbench.stage`` span; with
    ``trace``, the first full chunk split so that its first
    ``trace_steps`` steps run inside a ``Traced`` stretch."""

    def __init__(self, ctx, t0: float, full: int):
        self.ctx, self.t0, self.full = ctx, t0, full
        self.trace_steps = ctx.cell.workload["trace_steps"]
        self.closed = False
        self.traced: Optional[Traced] = None

    def feed(self, chunks):
        chunks = iter(chunks)
        while True:
            with torch.profiler.record_function("portbench.stage"):
                cur = next(chunks, None)
            if cur is None:
                return
            if self.ctx.trace and self.traced is None and \
                    cur.shape[0] == self.full:
                m = min(self.trace_steps, cur.shape[0])
                with Traced(self.ctx.device) as self.traced:
                    yield cur[:m]
                cur = cur[m:]
            yield cur
            if time.perf_counter() - self.t0 >= self.ctx.seconds:
                self.closed = True
                return


def run(ctx) -> Outcome:
    from vgd_tpu_torch.train.loop import _stream_epoch_scan

    cell, dev = ctx.cell, ctx.device
    cuda = dev.type == "cuda"
    k = cell.traffic["check_steps"]
    r = Run(ctx)
    chunks, pending = r.first_steps(k)
    if cuda:
        # release the eager warm-up steps' cached blocks: the replays run
        # in the step graph's own pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.log_phases()
    win = Window(ctx, t0, r.staging.ring.buffers[0].shape[0])
    # the chain holds the first chunk only until it has run
    epoch = itertools.chain([pending], chunks)
    del chunks, pending
    steps = failed = 0
    while True:
        sums, count, r.gstep = _stream_epoch_scan(r.graph, win.feed(epoch),
                                                  r.prof, r.gstep)
        steps += count
        if not _finite(sums):
            failed += count
        if win.closed:
            break
        r.epoch += 1
        epoch = r.chunks()
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    ctx.log(f"window {window_s:.3f} s, {steps} steps, {r.epoch + 1} "
            f"epoch(s), set-up {setup_s:.3f} s")
    del epoch
    r.free()
    checks_ = checks(r, reference_readings(r), cell.workload["limits"])
    b = cell.config["batch_size"]
    timeline = None
    if win.traced is not None:
        timeline = win.traced.timeline(
            {"step": min(win.trace_steps, win.full)})
    return Outcome(
        attempted=steps, failed=failed,
        e2e={"train_images_per_s": steps * b / window_s,
             "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
        checks=checks_, memory_peak_bytes=peak, timeline=timeline)
