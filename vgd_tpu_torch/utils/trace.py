"""Spans and counters at the boundaries of the port's host-side layers: the
epoch loop's step graph, the input staging, the samplers and Glow's
per-step trainer.

``span(name)`` marks a stretch of host work. While no ``torch.profiler`` is
active it costs one attribute read and returns the shared no-op context
``NO_SPAN``. While one is active (``--profile-dir``'s ``train.loop._Profiler``,
or any other caller's) it is ``torch.profiler.record_function(name)``, so
the span lands in the profiler's trace beside the kernels, on the same
clock, and names the device's idle gaps where the host was inside it. A
span is opened at most once a step, a forward or a chunk, never once a
kernel and never inside a CUDA graph's capture.

``COUNTERS`` is always on, as ``ops.kernels.LAUNCHES`` is: it times the
host with ``time.perf_counter`` whether or not a profiler is active (a
profiler slows the host it times), and is updated at most once a chunk, a
capture, a step graph's replay, a UNet forward or a Glow step, about a
µs each. Its keys:

* ``stage.chunks``: chunks staged by ``utils.prefetch.PinnedRing.stage``;
* ``stage.wait_s``: host seconds spent waiting on a ring buffer's copy
  event before refilling it;
* ``stage.busy_s``: host seconds filling a buffer and enqueueing its copy;
* ``graph.captures``, ``graph.capture_s``: CUDA-graph captures by
  ``train.common.StepGraph`` and their host seconds;
* ``graph.capture_reserved_bytes``: the device memory the caching allocator
  reserved during the captures (the graphs' private pools);
* ``graph.replay_min_s``: the least host seconds of one step graph replay
  (its input copy's and the replay's enqueue): the host's own cost, read
  where the launch queue had room (a replay behind a full queue waits for
  the device);
* ``sample.forward_min_s``: the least host seconds of one fused UNet
  forward of a sampler (``train.diffusion.DiffusionTrainer._eps``), read
  as the replay's is;
* ``glow.steps``, ``glow.step_min_s``: Glow train steps
  (``train.glow._GlowTrainerBase.train_step``, span ``vgd.glow.step``
  around ``vgd.glow.forward``, ``vgd.glow.backward`` and ``vgd.glow.adam``)
  and the least host seconds of one step's enqueue, read as the replay's
  is;
* ``glow.init_s``: host seconds of Glow's ActNorm init (span
  ``vgd.glow.init``).

The table is module-level and grows for the life of the process; a caller
that wants one run's numbers clears it first.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

COUNTERS: collections.Counter = collections.Counter()
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler is active, else
    ``NO_SPAN``."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(name: str, counter: str, least: bool = False):
    """``span(name)`` that also puts its host seconds in
    ``COUNTERS[counter]``, traced or not: added to it, or with ``least``
    kept there if fewer than any before."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        if least:
            COUNTERS[counter] = min(COUNTERS.get(counter, dt), dt)
        else:
            COUNTERS[counter] += dt
