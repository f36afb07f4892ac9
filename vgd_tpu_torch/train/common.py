"""Loss and optimizer primitives (``vgd_tpu/train/common.py``), the
data-parallel pieces every trainer shares: draws made for the global batch
and sliced (``batch_draw``), and metrics reported as the global batch's
(``mean_metrics``), and the epoch scan's step (``StepGraph``).

``StepGraph`` is the counterpart of ``scan_epoch``, JAX's ``lax.scan`` of
one train step over a stacked chunk of batches: on a card the step is
captured once as a CUDA graph and each step of a chunk is one replay of it,
so the host launches one graph a step instead of the step's hundreds of
kernels, and the metrics are summed on the device and read once an epoch.
On the CPU the same loop calls the step itself.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F

from vgd_tpu_torch.ops import kernels
from vgd_tpu_torch.parallel.collectives import all_mean
from vgd_tpu_torch.parallel.mesh import Mesh
from vgd_tpu_torch.utils import trace

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mse(a: torch.Tensor, b: torch.Tensor,
        reduction: str = "mean") -> torch.Tensor:
    """Squared error in f32, mean or sum over every element."""
    d = torch.square(a.float() - b.float())
    return d.mean() if reduction == "mean" else d.sum()


def bce(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities: ``torch.nn.BCELoss`` itself,
    the reference's loss. Mean over elements, both log terms clamped at
    -100 (the forward of the JAX package's ``bce``). Its backward stays
    finite where the f32 sigmoid saturates to exactly 0 or 1 (a confident
    discriminator at 256x256); the JAX function's gradient is 0/0 there."""
    p = p.float()
    return F.binary_cross_entropy(p, target.to(p.dtype).expand_as(p))


def adam(params: Iterable[torch.nn.Parameter], lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8,
         capturable: bool = False) -> torch.optim.Adam:
    """``optax.adam`` as a torch optimizer: both keep bias-corrected first
    and second moments and add eps outside the square root, so the update
    is the same (up to f32 rounding order). ``capturable`` (the trainers
    of the families with an epoch scan) takes effect on a card: the step
    count and the bias correction live on the device, so a step captured
    in a CUDA graph (``StepGraph``) advances them at every replay instead
    of freezing the host's values of the capture, and the per-step loop
    computes the same update bits as the scan. The CPU's Adam refuses
    ``capturable`` and keeps its count on the host."""
    params = list(params)
    cuda = any(p.is_cuda for p in params)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            capturable=capturable and cuda)


@torch.no_grad()
def clamp_params(module: torch.nn.Module, clip_value: float) -> None:
    """WGAN weight clipping: every ``nn.Parameter`` of ``module`` clamped to
    [-clip_value, clip_value] in place (BatchNorm's scale and shift too;
    its running statistics are buffers and stay as they are)."""
    for p in module.parameters():
        p.clamp_(-clip_value, clip_value)


@contextlib.contextmanager
def frozen_parameters(module: torch.nn.Module) -> Iterator[None]:
    """Forwards inside the block record no gradient for ``module``'s
    parameters (a G step's discriminator: its input gradient still flows,
    and no weight gradient is computed at all)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def batch_draw(mesh: Mesh, make: Callable[[tuple], torch.Tensor],
               shape: Sequence[int], axis: int = 0):
    """This rank's rows of ``make(global shape)``: a draw for the global
    batch, whose size is ``shape[axis]`` (this rank's rows) times the data
    axis. Every rank draws the same from its generator, which stays in
    step with a one-process run's; ``make`` may return a tuple of draws
    (``CorruptDraws``)."""
    glob = list(shape)
    glob[axis] *= mesh.data
    return mesh.rows(make(tuple(glob)), axis)


def mean_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over ``mesh.grad_group`` in one collective (a
    rank's loss estimates the global batch's, so their mean is the global
    one)."""
    if mesh.grad_group is None:
        return metrics
    vals = all_mean(torch.stack([metrics[k].detach().float()
                                 for k in metrics]), mesh.grad_group)
    return dict(zip(metrics, vals.unbind(0)))


# eager steps a StepGraph runs before it captures: cuBLAS and cuDNN handles
# and workspaces, Adam's lazily made state, the kernels' libraries (built
# and loaded at first use) and autograd's streams come into being in real
# steps, never inside a capture
WARMUP_STEPS = 2


class StepGraph:
    """One train step run over the stacked batches of chunks (``run``):
    the counterpart of ``scan_epoch``'s scanned step.

    ``step(batch)`` is one whole train step (forward, backward, optimizer
    updates) returning 0-d metric tensors; it advances ``owner.step``. The
    metrics are summed into device accumulators, read and zeroed once an
    epoch (``read``), so the log's ``train_*`` is the mean over every step,
    as the per-step loop computes it.

    On a card the first WARMUP_STEPS steps run eagerly on a side stream; they
    are training steps like any other. The next step is captured as a CUDA
    graph (batch in a static input slot, the accumulation inside), which
    runs nothing: ``owner.step``'s advance in the capture is taken back.
    Every step from then on copies its batch into the slot and replays the
    graph, and adds one to ``owner.step``. ``generator``, the run's
    ``torch.Generator``, is registered with the graph, so each replay draws
    what an eager step would draw next and leaves the generator where an
    eager step leaves it. Kernel launches recorded in the capture are taken
    out of ``kernels.LAUNCHES`` and added back at every replay. The capture
    and each replay are the spans ``vgd.graph.capture`` and
    ``vgd.graph.replay`` (``utils.trace``); the capture adds its host
    seconds and the device memory it reserved to ``trace.COUNTERS``, and a
    replay its host seconds where they are the least yet. A
    capture that fails raises: a card never falls back to eager steps. The
    graph holds the addresses of every tensor the step touches, so the loop
    makes one StepGraph a run, after the trainer's init or resume, and loads
    no state into the trainer while it is in use.

    On the CPU every step is the call ``step(batch)`` itself.
    """

    def __init__(self, step: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                 owner, generator: Optional[torch.Generator] = None):
        self.step, self.owner, self.generator = step, owner, generator
        self.device = owner.device
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.sums: Dict[str, torch.Tensor] = {}
        self.steps_run = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.slot: Optional[torch.Tensor] = None
        # kernel launches of one replay, by kernel
        self.captured: collections.Counter = collections.Counter()

    def run(self, chunk: torch.Tensor) -> None:
        """One step on each batch of ``chunk`` (n, B, ...), in order."""
        for batch in chunk:
            self.one(batch)

    def one(self, batch: torch.Tensor) -> None:
        """One train step on ``batch``: eager (the CPU, a warm-up step) or
        one replay of the captured graph."""
        if not self.cuda:
            self._accumulate(self.step(batch))
        elif self.steps_run < WARMUP_STEPS:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self._accumulate(self.step(batch))
            cur.wait_stream(self.stream)
        else:
            if self.graph is None:
                self._capture(batch)
            with trace.timed("vgd.graph.replay", "graph.replay_min_s",
                             least=True):
                self.slot.copy_(batch)
                self.graph.replay()
                self.owner.step += 1
                kernels.replayed(self.captured)
        self.steps_run += 1

    def _accumulate(self, metrics: Dict[str, torch.Tensor]) -> None:
        # the accumulators are made in the first (eager) step, so the
        # capture adds into them rather than into tensors of its own
        for k, v in metrics.items():
            if k not in self.sums:
                self.sums[k] = torch.zeros_like(v)
            self.sums[k].add_(v)

    def _capture(self, batch: torch.Tensor) -> None:
        with trace.timed("vgd.graph.capture", "graph.capture_s"):
            self.slot = torch.empty_like(batch)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            counter = self.owner.step
            with kernels.capturing() as launched:
                with torch.cuda.graph(graph):
                    # taken once the capture has begun: entering it empties
                    # the allocator's cache, so from here on what the
                    # allocator reserves is the graph's private pool
                    before = torch.cuda.memory_reserved(self.device)
                    self._accumulate(self.step(self.slot))
            pool = torch.cuda.memory_reserved(self.device) - before
        trace.COUNTERS.update({"graph.captures": 1,
                               "graph.capture_reserved_bytes": pool})
        self.owner.step = counter
        self.captured = launched
        self.graph = graph

    def read(self) -> Dict[str, float]:
        """The metrics' sums over the steps since the last read, read to
        the host at once; the accumulators start again from 0."""
        if not self.sums:
            return {}
        vals = torch.stack([v.double() for v in self.sums.values()]).tolist()
        for v in self.sums.values():
            v.zero_()
        return dict(zip(self.sums, vals))

