"""Serving DDIM requests in a closed loop: one client sends a request of
``images`` starting images x_T, drawn on the card from the request's seed,
waits for its images on the host (``ddim_sample`` then ``.cpu()``, as
``train.loop.sample_from_dir`` ends) and sends the next.

Set-up (``setup_s``): the weights (the reference's leaves from the weights
seed), the program's trainer, and one whole request to warm up every shape
and build the kernels. The window sends requests until ``--seconds`` have
passed; ``sample_images_per_s`` is every image of every request over the
time from the window's start to the last request's end, less the failed
requests: one that raises, or whose images are not all finite (read after
the window, with the rest of the check). With ``--trace 1`` the profiler
traces ``trace_requests`` requests from request ``trace_from`` on; the
check's requests come after them.

The check follows the program step by step from its own states: the
random weights make the chain's images saturate at -1 or 1 whatever the
network computes, so the final images alone would say nothing of the
UNet. For ``check_requests`` requests drawn from the run's check seed
among requests ``check_from`` to ``check_within`` - 1, a forward hook
copies the fused UNet's input and output of every forward of the chain
into pinned host buffers (one set a checked request, made in set-up), on
the stream, without a synchronisation. Once the window has closed and the
program is freed, the f32 reference checks:

* ``start_gap``: the first forward's input against x_T (exact);
* ``eps_gap``: each recorded forward's noise prediction against the
  reference UNet on the same input and timestep, ||a - b|| / ||b||, the
  geometric mean of them (a steady number: the gap is nearly the same for
  any input at one timestep and one set of weights, and its worst case
  swings with the weights, the control's with it; PERF.md);
* ``eps_ratio_max``: the worst forward's gap over the gap of the
  reference with its products' operands rounded to bf16 (the
  configuration's compute dtype) on the same input: how many times the
  rounding of the configuration's own precision the program strays at
  its worst forward. The yardstick swings with the weights as the
  program's gap does, so one forward gone wrong stands out where the
  geometric mean would dilute it;
* ``update_gap``: the DDIM update (in f64) of each recorded input and
  prediction against the next recorded input, and of the last against the
  request's images (clamped), ||a - b|| / ||b||.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from portbench import compare
from portbench.harness import Check, Outcome, program_seed, seed_of
from portbench.reference.ops import PRECISIONS, exact_f32
from portbench.timeline import Traced
from portbench.drivers.train_scan import make_weights


def x_start(cfg: dict, images: int, seed: int, i: int, device):
    """Request ``i``'s starting images from its own seed."""
    s = cfg["image_size"]
    g = torch.Generator(device=device).manual_seed(seed_of(seed, f"x{i}"))
    return torch.randn((images, s, s, cfg["channels"]), generator=g,
                       device=device)


def check_plan(traffic: dict, seed: int):
    """The request indices whose forwards the check records."""
    rng = np.random.default_rng(seed_of(seed, "check"))
    return sorted(int(i) for i in rng.choice(
        np.arange(traffic["check_from"], traffic["check_within"]),
        traffic["check_requests"], replace=False))


class Recorder:
    """A forward hook that copies the UNet's input x, timestep and output
    of every forward of an armed request into that request's pinned
    buffers."""

    def __init__(self, requests: int, steps: int, shape, device):
        pin = device.type == "cuda"
        self.steps = steps
        self.x = [[torch.empty(shape, pin_memory=pin) for _ in range(steps)]
                  for _ in range(requests)]
        self.eps = [[torch.empty(shape, pin_memory=pin)
                     for _ in range(steps)] for _ in range(requests)]
        self.t = []
        self.armed, self.count = False, 0

    def __call__(self, module, args, output):
        if not self.armed:
            return
        if self.count < self.steps:
            slot = len(self.t) - 1
            self.x[slot][self.count].copy_(args[0], non_blocking=True)
            self.eps[slot][self.count].copy_(output, non_blocking=True)
            self.t[slot].append(args[1])
        self.count += 1

    def arm(self) -> None:
        self.armed, self.count = True, 0
        self.t.append([])

    def disarm(self) -> None:
        self.armed = False

    def records(self):
        """After the recorded requests have reached the host: for each, a
        dict position -> (x, timestep, eps)."""
        return [{p: (self.x[r][p], int(t[p][0]), self.eps[r][p])
                 for p in range(len(t))} for r, t in enumerate(self.t)]


def ddim_update(x, eps, at, ap):
    x0 = (x - math.sqrt(1.0 - at) * eps) / math.sqrt(at)
    return math.sqrt(ap) * x0 + math.sqrt(max(1.0 - ap, 0.0)) * eps


def readings(ctx, params, records, starts, outputs, control=None):
    """The check's numbers of the recorded requests against the f32
    reference: ``start_gap``, ``eps_gap`` (the geometric mean of the
    recorded forwards' gaps), ``eps_ratio_max``, ``update_gap``; and, to
    look into them, the worst forward's gap, the pooled gap and each
    forward's (position, gap, yardstick). With ``control`` (a precision of
    ``PRECISIONS``) the reference computed in it stands in for the
    program's predictions."""
    cfg, ref = ctx.cell.config, ctx.cell.module("reference")
    dev = ctx.device
    exact_f32()
    steps = ctx.cell.traffic["steps"]
    taus = ref.ddim_timesteps(cfg["timesteps"], steps)
    acp = ref.alphas_cumprod(cfg, "cpu").double().tolist() + [1.0]
    start = upd = 0.0
    each, err2, ref2 = [], 0.0, 0.0
    for rec, x_t, out in zip(records, starts, outputs):
        start = max(start, float((rec[0][0] - x_t.cpu()).abs().max()))
        for p, (x, t, eps) in rec.items():
            xd = x.to(dev)
            tt = torch.full((x.shape[0],), taus[p], device=dev)
            with torch.no_grad():
                want = ref.unet(params, xd, tt, cfg).double()
                yard = ref.unet(params, xd, tt, cfg,
                                PRECISIONS["bfloat16"]).double()
                got = eps.to(dev).double() if control is None else \
                    ref.unet(params, xd, tt, cfg,
                             PRECISIONS[control]).double()
            diff, norm = float((got - want).norm()), float(want.norm())
            gap = diff / norm if t == taus[p] else math.inf
            each.append((p, gap, float((yard - want).norm()) / norm))
            err2, ref2 = err2 + diff ** 2, ref2 + norm ** 2
            prev = taus[p + 1] if p + 1 < steps else cfg["timesteps"]
            nxt = ddim_update(x.double(), eps.double(), acp[taus[p]],
                              acp[prev])
            if p + 1 in rec:
                upd = max(upd, compare.relative(rec[p + 1][0], nxt))
            elif p == steps - 1:
                upd = max(upd, compare.relative(out, nxt.clamp(-1.0, 1.0)))
    gaps = [g for _, g, _ in each]
    return {"start_gap": start, "eps_gap": _geomean(gaps),
            "eps_ratio_max": max((g / y if y > 0 else math.inf
                                  for _, g, y in each), default=math.inf),
            "update_gap": upd,
            "eps_gap_max": max(gaps, default=math.inf),
            "eps_gap_pooled": math.sqrt(err2 / ref2) if ref2 else math.inf,
            "eps_each": each}


def _geomean(gaps) -> float:
    if not gaps or not all(0 < g < math.inf for g in gaps):
        return 0.0 if gaps and all(g == 0 for g in gaps) else math.inf
    return math.exp(sum(math.log(g) for g in gaps) / len(gaps))


def run(ctx) -> Outcome:
    cell, dev, seed = ctx.cell, ctx.device, ctx.seed
    cfg, traffic = cell.config, cell.traffic
    cuda = dev.type == "cuda"
    images, steps, eta = traffic["images"], traffic["steps"], traffic["eta"]
    ref = cell.module("reference")
    ctx.mark("imports")
    params = make_weights(ref, cfg, seed, dev)
    ctx.mark("weights")
    request, unet = cell.module("families").sampler(cfg, params,
                                                    program_seed(seed), dev)
    ctx.mark("program")
    reqs = check_plan(traffic, seed)
    s = cfg["image_size"]
    rec = Recorder(len(reqs), steps, (images, s, s, cfg["channels"]), dev)
    hook = unet.register_forward_hook(rec)
    warm = x_start(cfg, images, seed, -1, dev)
    request(warm, steps, eta)
    del warm
    ctx.mark("warm-up request")
    if cuda:
        # the warm-up request's cached blocks are the ones every request
        # reuses: reserved memory is the serving footprint from here on
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.log_phases()
    times, failed, outputs = [], 0, []
    traced, first = None, traffic["trace_from"]
    last = first + traffic["trace_requests"] - 1
    t_last = t0
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        x_t = x_start(cfg, images, seed, i, dev)
        if i in reqs:
            rec.arm()
        if ctx.trace and i == first:
            traced = Traced(dev).__enter__()
        ta = time.perf_counter()
        try:
            outputs.append(request(x_t, steps, eta))
        except RuntimeError as err:
            ctx.log(f"request {i} raised {err!r}")
            outputs.append(None)
            failed += 1
        t_last = time.perf_counter()
        if traced is not None and i == last:
            traced.__exit__(None, None, None)
        times.append(t_last - ta)
        if i in reqs:
            rec.disarm()
        i += 1
    window_s = t_last - t0
    if traced is not None and i <= last:
        traced.__exit__(None, None, None)
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    hook.remove()
    ctx.log(f"window {window_s:.3f} s, {i} requests, set-up {setup_s:.3f} s")
    del request, unet
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = [j for j, o in enumerate(outputs)
           if o is not None and not bool(torch.isfinite(o).all())]
    failed += len(bad)
    done = [r for r in reqs if r < i]
    records = rec.records()
    if any(outputs[r] is None for r in done):
        done = []
    got = readings(ctx, params, records,
                   [x_start(cfg, images, seed, r, dev).cpu() for r in done],
                   [outputs[r] for r in done])
    worst = sorted(got["eps_each"], key=lambda e: e[1] / max(e[2], 1e-300))
    ctx.log("eps gap / bf16 yardstick, the 5 worst forwards by position: "
            + ", ".join(f"{p} {g:.5f}/{y:.5f}" for p, g, y in worst[-5:])
            + f"; worst gap {got['eps_gap_max']:.5f}, pooled "
            f"{got['eps_gap_pooled']:.5f}")
    lim = cell.workload["limits"]
    checks = [Check(k, got[k] if len(done) == len(reqs) else math.inf,
                    lim[k]) for k in lim]
    timeline = None
    if traced is not None:
        n = traffic["trace_requests"]
        timeline = traced.timeline({"request": n, "forward": n * steps})
    return Outcome(
        attempted=i, failed=failed,
        e2e={"sample_images_per_s": images * (i - failed) / window_s,
             "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, timeline=timeline,
        extra={"request_s_p50": statistics.median(times) if times else None})
