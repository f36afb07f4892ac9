"""Host -> device input staging (``vgd_tpu/utils/prefetch.py``).

``device_prefetch`` copies host batches to the device with
``non_blocking=True``, so the copy runs on the stream while the host
prepares the next batches and the device finishes the previous step;
``size`` copies stay in flight; each array is copied into pinned memory
first (``pin_memory()``).

The training loops stage their batches without that extra copy:
``stage_chunks`` gathers each chunk's batches with the native gather
(``data/native.py``) straight into the next buffer of a ``PinnedRing``,
pinned on a card, and the ring enqueues the buffer's copy to the card. PyTorch's caching host
allocator keeps a buffer made by ``pin_memory()`` alive until its copy has
finished; a ring buffer is reused by hand instead, so the ring records a
CUDA event after each copy and refills a buffer only after that buffer's
event has completed. Each ``stage`` adds to ``utils.trace.COUNTERS`` (its
chunk, its wait and fill seconds) and, while a profiler is active, opens
the spans ``vgd.stage.wait`` and ``vgd.stage.fill``.
"""
from __future__ import annotations

import collections
import itertools
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from vgd_tpu_torch.data import native
from vgd_tpu_torch.utils import trace


def _ahead(items: Iterator, size: int) -> Iterator:
    """``items`` in order, each taken from ``items`` while the consumer
    still holds the ``size - 1`` before it (the transfers in flight)."""
    queue = collections.deque()
    for item in items:
        queue.append(item)
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


class PinnedRing:
    """``slots`` host buffers of one shape (uint8), filled in turn by
    ``stage``: pinned on a card, plain host tensors on the CPU. A consumer
    holds at most ``slots - 1`` of the ring's staged tensors at a time (on
    the CPU a staged tensor is a view of its buffer)."""

    def __init__(self, shape: Sequence[int], device, slots: int = 2):
        if slots < 2:
            raise ValueError(f"a ring needs at least two buffers, got {slots}")
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.buffers = [torch.empty(tuple(shape), dtype=torch.uint8,
                                    pin_memory=cuda) for _ in range(slots)]
        self.events: list = [None] * slots
        self.turn = 0

    def wait(self, k: int) -> None:
        """Block until buffer ``k``'s last copy to the card has completed."""
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None

    def stage(self, fill: Callable[[torch.Tensor], None],
              n: int) -> torch.Tensor:
        """``fill`` the next buffer, once its last copy has completed, and
        return its first ``n`` rows on the device: on a card a
        non-blocking copy with an event recorded after it, which the
        buffer's next turn waits on; on the CPU the buffer's view."""
        k = self.turn % len(self.buffers)
        self.turn += 1
        with trace.timed("vgd.stage.wait", "stage.wait_s"):
            self.wait(k)
        with trace.timed("vgd.stage.fill", "stage.busy_s"):
            fill(self.buffers[k])
            out = self.buffers[k][:n]
            if self.device.type == "cuda":
                out = out.to(self.device, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                self.events[k] = ev
        trace.COUNTERS["stage.chunks"] += 1
        return out


def fill_chunk(data: np.ndarray, selections: Sequence[np.ndarray],
               buf: torch.Tensor, n_threads: Optional[int] = None) -> None:
    """buf[i] = data[selections[i]] for each selection (the rows of one
    batch), gathered by the native gather straight into ``buf`` (n, rows,
    ...): the chunk's rows in one call, so its threads start once a chunk,
    not once a batch; ``n_threads`` (None: ``native.threads_for`` the
    chunk's bytes)."""
    if any(len(sel) != buf.shape[1] for sel in selections):
        raise ValueError(f"each selection must have {buf.shape[1]} rows")
    rows = np.concatenate(selections)
    if n_threads is None:
        n_threads = native.threads_for(rows.size * data[0].nbytes)
    native.gather_rows_at(data, rows,
                          buf.numpy().reshape((-1,) + data.shape[1:]), 0,
                          n_threads)


def stage_chunks(data: np.ndarray, selections: Iterable[np.ndarray],
                 ring: PinnedRing, steps: Optional[int] = None,
                 rows: Callable = lambda sel: sel,
                 fill: Callable = fill_chunk,
                 size: int = 1) -> Iterator[torch.Tensor]:
    """Device chunks of up to ``ring``'s buffer length of batches:
    ``rows(sel)`` of ``data`` for each selection (this rank's rows of the
    step's global batch), gathered into the next ring buffer by ``fill``
    and staged (``PinnedRing.stage``); at most ``steps`` batches in all
    (None: until ``selections`` ends). Each chunk is (k, rows, ...), the
    last one shorter; the next ``size - 1`` are staged while the consumer
    holds one."""
    it = iter(selections)
    per = ring.buffers[0].shape[0]

    def staged():
        count = 0
        while steps is None or count < steps:
            n = per if steps is None else min(per, steps - count)
            sels = [rows(sel) for sel in itertools.islice(it, n)]
            if not sels:
                return
            count += len(sels)
            yield ring.stage(lambda buf: fill(data, sels, buf), len(sels))
    return _ahead(staged(), size)


def device_prefetch(iterator: Iterator[np.ndarray], size: int = 2,
                    device="cuda") -> Iterator[torch.Tensor]:
    """Yield the iterator's host arrays as tensors on ``device``, keeping
    ``size`` transfers in flight."""
    device = torch.device(device)

    def put(batch):
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return _ahead(map(put, iterator), size)
