"""Host -> device input prefetching (``vgd_tpu/utils/prefetch.py``).

Batches are copied from pinned host memory with ``non_blocking=True``, so
the copy runs on the stream while the host prepares the next batches and
the device finishes the previous step; ``size`` copies stay in flight.
"""
from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch


def device_prefetch(iterator: Iterator[np.ndarray], size: int = 2,
                    device="cuda") -> Iterator[torch.Tensor]:
    """Yield the iterator's host arrays as tensors on ``device``, keeping
    ``size`` transfers in flight."""
    device = torch.device(device)
    queue = collections.deque()

    def put(batch):
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
