"""Training through the per-step stream, as ``train.loop.run_glow`` runs
it: an endless shuffled stream of the train split, staged one batch at a
time by the run's ``_Staging``, the ActNorm init on the stream's first
batch, then one eager ``train_step`` a batch through the program's own
loop ``train.loop._glow_steps``.

Set-up (counted in ``setup_s``): the rows (as ``train_scan`` makes them),
the weights (the reference's ``weights`` from the weights seed), the
program's trainer, loader and staging, the ActNorm init on batch 0, and
iterations 0 .. ``check_steps`` - 1 (batches 1 .. ``check_steps``, at
least 2) through ``_glow_steps``, read one by one. The window runs
``_glow_steps`` on the stream's following batches until the first step
past ``--seconds`` and ends at a ``torch.cuda.synchronize()``; sampling,
logging and checkpoints (``run_glow``'s ``after``) stay out.
``train_images_per_s`` is every image of every step in the window over the
window's whole time. With ``--trace 1`` the window's ``trace_steps`` steps
after its first ``trace_from`` run inside a ``Traced`` stretch, from a
drained card to a drained card.

The check, after the window (``gaps``): the reference runs the init on the
same weights, batch and draw, in f32; then the checked steps from the
program's own state after its init, on the same batches and draws; and the
last checked step once more from the program's own state before it. The
numbers, each ``ok`` at most its limit:

* ``init_gap``: the larger of the ActNorm scales' error, ||s_program -
  s_reference|| over ||s_reference|| pooled over the flows, and the RMS of
  (b_program - b_reference) s_reference, the offsets' error in units of
  each input's standard deviation;
* ``batch_gap``: the worst consumed batch's share of bytes that differ from
  the rows the traffic gives it, the init's batch included: 0 exactly;
* ``draw_gap``: the same of the dequantisation draws (the U(0, 1) draw
  ``_noise`` returns, before the 1 / n_bins): each step's own draw of the
  run's generator, 0 exactly;
* ``grad_err_<group>``: the first gradients' error pooled over the leaves
  of each of the reference's ``groups`` (the coupling networks, ActNorm
  with the 1x1 convolutions, the priors), as ``compare`` pools it;
* ``step_err``: the last checked step's first moments against the
  reference's step from the program's parameters, moments and counts
  before it, over the part of the moment the step wrote (``compare``'s
  ``replay_err``), every leaf pooled;
* ``logp_gap``, ``logdet_gap``: the relative gap of the reported log p(z)
  and log-determinant (bits per dimension), apart, since the loss's
  constant -log(n_bins) term would dilute either: the worse of the first
  step (both from the same state) and the last checked step (the
  reference's from the program's state before it). The steps between are
  not compared: Adam's first, sign-like update moves every weight by
  about lr whatever the size of its gradient, and from the benchmark's
  random weights it moves the loss by an order of magnitude, so two
  trajectories whose first gradients differ by rounding part at once;
* ``change_gap``: as ``compare`` has it (1 for a state left unchanged).

Logged, not compared: ``loss_gap`` (taken as ``logp_gap`` is) and the
reference's loss, log_p and logdet at the first and the last checked step.
``readings`` gives the numbers that the limits were set from: the
program's, the control's (the reference with its bf16 operands rounded to
fp8, init and steps, in the program's place), the reference's with them
rounded to bf16 (what rounding alone reads) and each fault's of
``faults_glow`` (``readings_glow.py`` on the card).
"""
from __future__ import annotations

import gc
import itertools
import math
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from portbench import compare
from portbench.drivers.train_scan import (_host, _host1, epoch_selections,
                                         make_rows)
from portbench.harness import Check, Outcome, program_seed, seed_of
from portbench.reference.ops import PRECISIONS, Adam, exact_f32
from portbench.timeline import Traced


class StreamReadings(NamedTuple):
    """What a run (or the reference in the program's place) gives, host
    tensors by leaf name: the ActNorm leaves after the init; every leaf
    and buffer after it (the steps' start); the init's and each step's
    consumed batch and dequantisation draw; each step's loss, log_p and
    logdet; each leaf's first gradient; the first moments after step 1;
    each leaf's change over the steps; (parameter, first moment, second
    moment, Adam count) before the last step; (parameter, first moment,
    Adam count) after it."""
    init: Dict[str, torch.Tensor]
    start: Dict[str, torch.Tensor]
    batches: List[torch.Tensor]
    draws: List[torch.Tensor]
    losses: List[dict]
    first: Dict[str, torch.Tensor]
    moments: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]
    before: Dict[str, tuple]
    after: Dict[str, tuple]


def stream_batches(cfg: dict, seed: int, n: int) -> list:
    """The indices of the stream's first ``n`` batches, by the traffic's
    rule: epoch after epoch of ``train_scan.epoch_selections``."""
    out = []
    for epoch in itertools.count():
        out += epoch_selections(cfg, seed, epoch)[:n - len(out)]
        if len(out) >= n:
            return out


def _until(batches, t0: float, seconds: float):
    """``batches`` until the first one taken ``seconds`` after ``t0``."""
    for b in batches:
        yield b
        if time.perf_counter() - t0 >= seconds:
            return


class Run:
    """The program's objects of one run and the readings of its set-up.
    ``rows`` and ``params0`` may be handed over from an earlier run of the
    same seed."""

    def __init__(self, ctx, rows=None, params0=None):
        from vgd_tpu_torch.data.celeba import ArrayDataset, Loader, \
            split_dataset
        from vgd_tpu_torch.parallel.mesh import LOCAL
        from vgd_tpu_torch.train.loop import _Profiler, _staging

        cell, dev, seed = ctx.cell, ctx.device, ctx.seed
        self.ctx, self.cfg = ctx, cell.config
        self.seed = program_seed(seed)
        self.ref = cell.module("reference")
        ctx.mark("imports")
        self.rows = make_rows(self.cfg, seed, dev) if rows is None else rows
        ctx.mark("rows")
        if params0 is None:
            g = torch.Generator(device=dev).manual_seed(
                seed_of(seed, "weights"))
            params0 = self.ref.weights(self.cfg, g, dev)
        self.params0 = params0
        ctx.mark("weights")
        ds = ArrayDataset(self.rows)
        tr_idx, _ = split_dataset(ds, self.cfg["train_fraction"], self.seed)
        loader = Loader(ds, tr_idx, self.cfg["batch_size"], shuffle=True,
                        seed=self.seed)
        self.system = cell.module("families").TrainSystem(
            self.cfg, ds.image_shape, self.params0, self.seed, dev)
        ctx.mark("trainer")
        self.staging = _staging(loader, LOCAL, dev, False, 0)
        self.batches = self.staging.batches(loader.stream_selections(0))
        # the loop's profiler, off as in a run without --profile-dir
        self.prof = _Profiler(self.system.trainer.cfg.run, dev, False)
        ctx.mark("staging")

    def adam_state(self) -> dict:
        """By leaf: (parameter, first moment, second moment, Adam count),
        on the host."""
        opt = self.system.trainer.opt
        out = {}
        for n, p in self.system.leaves().items():
            st = opt.state.get(p, {})
            zero = torch.zeros_like(p)
            out[n] = (_host1(p), _host1(st.get("exp_avg", zero)),
                      _host1(st.get("exp_avg_sq", zero)),
                      int(st["step"]) if "step" in st else 0)
        return out

    def set_up(self, k: int) -> None:
        """The ActNorm init on the stream's first batch, then iterations 0
        .. k - 1 through ``_glow_steps``, read one by one
        (``readings``)."""
        from vgd_tpu_torch.train.loop import _glow_steps

        system, tr = self.system, self.system.trainer
        drawn = []
        noise = tr._noise

        def recorded_noise(x, generator, given):
            out = noise(x, generator, given)
            drawn.append(out.to("cpu", copy=True))
            return out
        # on the instance, for the set-up only: the window's steps call the
        # class's own
        tr._noise = recorded_noise
        b0 = next(self.batches)
        system.init_step(b0)
        batches = [b0.to("cpu", copy=True)]
        state = tr.model.state_dict()
        init = _host({n: t for n, t in state.items() if ".actnorm." in n})
        start = _host(state)
        names = {id(p): n for n, p in system.leaves().items()}
        first, seen, losses, kept = {}, [], [], {}

        def grab(opt, args, kwargs):
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        first.setdefault(names[id(p)], _host1(p.grad))
        hook = tr.opt.register_step_pre_hook(grab)

        def recorded(it):
            for b in it:
                seen.append(b)
                yield b

        def after(i, m):
            losses.append({n: float(v) for n, v in m.items()})
            batches.append(seen[-1].to("cpu", copy=True))
            if i == 0:
                hook.remove()
                kept["moments"] = {n: s[1] for n, s in
                                   self.adam_state().items()}
            if i == k - 2:
                kept["before"] = self.adam_state()
        _glow_steps(tr, recorded(self.batches), system.generator, self.prof,
                    0, k, after)
        del tr._noise
        now = self.adam_state()
        self.readings = StreamReadings(
            init, start, batches, drawn, losses, first, kept["moments"],
            {n: s[0] - start[n] for n, s in now.items()}, kept["before"],
            {n: (s[0], s[1], s[3]) for n, s in now.items()})
        self.ctx.mark("first steps")

    def free(self) -> None:
        """Drop the program's state (the reference runs after it)."""
        for name in ("batches", "staging", "system", "prof"):
            setattr(self, name, None)
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def _batches(run: Run, n: int) -> list:
    return [torch.from_numpy(run.rows[s]).to(run.ctx.device)
            for s in stream_batches(run.cfg, run.seed, n)]


def _generator(run: Run, draws: int) -> torch.Generator:
    """The run's generator after ``draws`` steps' dequantisation draws."""
    cfg, dev = run.cfg, run.ctx.device
    g = torch.Generator(device=dev).manual_seed(run.seed)
    for _ in range(draws):
        run.ref.draws(g, cfg, cfg["batch_size"], dev)
    return g


def reference_init(run: Run, precision: str = "float32"):
    """(the ActNorm leaves, every leaf and buffer) after the reference's
    init on the stream's first batch and the run's first draw."""
    exact_f32()
    params = {n: v.clone() for n, v in run.params0.items()}
    stats = run.ref.init_actnorm(params, _batches(run, 1)[0],
                                 _generator(run, 0), run.cfg,
                                 PRECISIONS[precision])
    return _host(stats), _host(params)


def reference_steps(run: Run, init: dict, start: dict,
                    precision: str = "float32") -> StreamReadings:
    """The reference's readings over the checked steps from ``start`` (the
    state after an init whose ActNorm leaves are ``init``), on the
    stream's batches and the run's draws, as ``Run.set_up`` keeps the
    program's."""
    ctx, cfg, ref = run.ctx, run.cfg, run.ref
    exact_f32()
    k = ctx.cell.traffic["check_steps"]
    params = {n: v.to(ctx.device, copy=True) for n, v in start.items()}
    kept = {}

    def state(adam, with_v):
        return {n: (_host1(params[n]), _host1(adam.m[n]))
                + ((_host1(adam.v[n]),) if with_v else ()) + (adam.t[n],)
                for n in adam.m}

    def tap(i, adam):
        if i == 0:
            kept["moments"] = _host(adam.m)
            kept["first"] = _host(adam.first)
        if i == k - 2:
            kept["before"] = state(adam, True)
        if i == k - 1:
            kept["after"] = state(adam, False)
    batches = _batches(run, k + 1)
    g = _generator(run, 0)
    draws = [ref.draws(g, cfg, cfg["batch_size"], ctx.device).cpu()
             for _ in range(k + 1)]
    losses = ref.train_steps(params, batches[1:], _generator(run, 1), cfg,
                             PRECISIONS[precision], tap=tap)
    names = [n for n in params if ref.trained(n)]
    return StreamReadings(
        init, start, [b.cpu() for b in batches], draws, losses, kept["first"],
        kept["moments"], {n: _host1(params[n]) - start[n] for n in names},
        kept["before"], kept["after"])


def reference_step(run: Run, before: dict, start: dict):
    """The reference's last checked step in f32 from ``before`` (by leaf:
    parameter, moments and Adam count; buffers from ``start``), on the
    batch and draw the traffic and the run's seed give it: its Adam
    (``compare.Forced``) and its loss, log_p and logdet."""
    ctx, cfg, ref = run.ctx, run.cfg, run.ref
    dev = ctx.device
    exact_f32()
    k = ctx.cell.traffic["check_steps"]
    params = {n: v.to(dev, copy=True) for n, v in start.items()}
    params.update({n: s[0].to(dev, copy=True) for n, s in before.items()})
    adam = Adam(cfg["lr"])
    adam.load({n: (m.to(dev), v.to(dev), t)
               for n, (_, m, v, t) in before.items() if t})
    losses = ref.train_steps(params, _batches(run, k + 1)[-1:],
                             _generator(run, k), cfg, PRECISIONS["float32"],
                             adam=adam)
    wrote = {n: adam.m[n] - adam.b1 ** (adam.t[n] - before[n][3])
             * before[n][1].to(dev) for n in adam.m}
    return compare.Forced(_host(adam.m), dict(adam.t), _host(wrote)), \
        losses[0]


def init_gap(got: dict, want: dict) -> float:
    """The larger of the scales' pooled error and the offsets' RMS error
    in units of the input's standard deviation."""
    names = [n for n in want if n.endswith(".s")]
    s_err = compare.pooled(got, want, want, names)
    num = sum(float(((got[n[:-1] + "b"] - want[n[:-1] + "b"]).double()
                     * want[n].double()).square().sum()) for n in names)
    count = sum(want[n].numel() for n in names)
    return max(s_err, math.sqrt(num / count))


def _key_gap(prog: List[dict], ref: List[dict], key: str) -> float:
    """The worse relative gap of ``key`` in the first and the last of the
    checked steps (``ref``: the reference's first and last)."""
    return compare.loss_gap([{key: p[key]} for p in (prog[0], prog[-1])],
                            [{key: r[key]} for r in ref])


def gaps(run: Run, cand: StreamReadings, ref_init: dict) -> dict:
    """The numbers of ``cand`` (the program's readings, or the reference's
    in its place) against the reference: its init (``ref_init``), its steps
    from ``cand``'s state after the init, and its last step from ``cand``'s
    state before that step."""
    ref = reference_steps(run, ref_init, cand.start)
    forced, last = reference_step(run, cand.before, cand.start)
    ends = [ref.losses[0], last]
    out = {"init_gap": init_gap(cand.init, ref_init),
           "batch_gap": compare.batch_gap(cand.batches, ref.batches),
           "draw_gap": compare.batch_gap(cand.draws, ref.draws)}
    names = list(ref.first)
    for g, group in compare.group_names(names, run.ref.groups(
            run.cfg)).items():
        out["grad_err_" + g] = compare.pooled(cand.first, ref.first,
                                              ref.first, group)
    counts = all(cand.after.get(n, (None,) * 3)[2] == forced.t[n]
                 for n in names)
    out["step_err"] = compare.pooled(
        {n: cand.after[n][1] for n in names if n in cand.after}, forced.m,
        forced.wrote, names) if counts else math.inf
    floor = compare.threshold(ref.moments)
    gap, at = compare.leaf_gap(
        compare.masked_norms(cand.change, ref.moments, floor),
        compare.masked_norms(ref.change, ref.moments, floor))
    out.update({"logp_gap": _key_gap(cand.losses, ends, "log_p"),
                "logdet_gap": _key_gap(cand.losses, ends, "logdet"),
                "change_gap": gap, "change_leaf": at,
                "loss_gap": _key_gap(cand.losses, ends, "loss"),
                **{f"ref{i}_{n}": v for i, step in zip((1, len(cand.losses)),
                                                       ends)
                   for n, v in step.items()}})
    return out


def control(run: Run, precision: str = "float8") -> StreamReadings:
    """The reference computed in ``precision``, init and steps, as the
    readings of a run in the program's place."""
    init, start = reference_init(run, precision)
    return reference_steps(run, init, start, precision)


def readings(ctx, with_control: bool, faults: Optional[dict] = None):
    """[(kind, numbers)]: the program's set-up against the reference, and
    with ``with_control`` the control's and each of ``faults``' (name ->
    context manager over the cell; a fault that raises reads its
    error)."""
    k = ctx.cell.traffic["check_steps"]
    r = Run(ctx)
    r.set_up(k)
    r.free()
    ref_init, _ = reference_init(r)
    rows = [("program", gaps(r, r.readings, ref_init))]
    if with_control:
        rows.append(("control", gaps(r, control(r), ref_init)))
        rows.append(("bfloat16", gaps(r, control(r, "bfloat16"), ref_init)))
        for name, fault in (faults or {}).items():
            try:
                with fault(ctx.cell):
                    bad = Run(ctx, r.rows, r.params0)
                    bad.set_up(k)
                bad.free()
                rows.append(("fault_" + name,
                             gaps(bad, bad.readings, ref_init)))
            except Exception as err:  # a fault that crashes fails its run
                rows.append(("fault_" + name, {"error": repr(err)}))
    return rows


def run(ctx) -> Outcome:
    # a program without the per-step loop's function fails here, before
    # any set-up
    from vgd_tpu_torch.train.loop import _glow_steps

    cell, dev = ctx.cell, ctx.device
    cuda = dev.type == "cuda"
    k = cell.traffic["check_steps"]
    r = Run(ctx)
    r.set_up(k)
    if cuda:
        # the window's peak is the steps' own, not the init pass's
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.log_phases()
    tr, gen = r.system.trainer, r.system.generator
    losses = []

    def keep(i, m):
        losses.append(m["loss"])
    steps, traced = 0, None
    if ctx.trace:
        # past the steps that refill the allocator's cache after set-up
        m, n = cell.workload["trace_from"], cell.workload["trace_steps"]
        steps += _glow_steps(tr, itertools.islice(r.batches, m), gen, r.prof,
                             k, k + m, keep)
        with Traced(dev) as traced:
            steps += _glow_steps(tr, itertools.islice(r.batches, n), gen,
                                 r.prof, k + m, k + m + n, keep)
    steps += _glow_steps(tr, _until(r.batches, t0, ctx.seconds), gen, r.prof,
                         k + steps, sys.maxsize, keep)
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    losses = torch.stack(losses).cpu()
    failed = int((~torch.isfinite(losses)).sum())
    ctx.log(f"window {window_s:.3f} s, {steps} steps, set-up "
            f"{setup_s:.3f} s; loss first {float(losses[0]):.4g}, last "
            f"{float(losses[-1]):.4g}, largest {float(losses.max()):.4g}")
    del losses
    r.free()
    ref_init, _ = reference_init(r)
    got = gaps(r, r.readings, ref_init)
    ctx.log(", ".join(f"{n} {v:.6g}" if isinstance(v, float) else
                      f"{n} {v}" for n, v in got.items()))
    limits = cell.workload["limits"]
    timeline = None
    if traced is not None:
        timeline = traced.timeline({"step": cell.workload["trace_steps"]})
    return Outcome(
        attempted=steps, failed=failed,
        e2e={"train_images_per_s": steps * cell.config["batch_size"]
             / window_s, "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
        checks=[Check(n, got[n], limits[n]) for n in limits],
        memory_peak_bytes=peak, timeline=timeline)
