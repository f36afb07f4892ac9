"""Entry points of the port (``vgd_tpu/train/loop.py``): DDPM training
(``run_diffusion``), VAE-GAN training (``run_vaegan``), denoising-VAE
training (``run_vae``) with its aggregated-posterior checkpoint sweep
(``evaluate_vae_checkpoints``), occlusion test (``evaluate_vae_occlusion``)
and image restoration (``denoise_images``), DCGAN / WGAN training
(``run_gan``) and its checkpoint sweep (``evaluate_gan_checkpoints``), Glow
training (``run_glow``) and its temperature-sampled evaluation
(``evaluate_glow``), EEG Glow training per event type (``run_glow_eeg``)
with its PSD comparison (``eeg_psd_and_gif``), sample grids from a
checkpoint of any of them and partial-noise restoration evaluation. Every
evaluation takes an Inception ``feature_fn`` (``load_feature_fn``) for FID,
IS and manifold precision / recall beside SSIM.

Grids and panels are written as ``.npy`` arrays in [-1, 1] with a picture
beside them where PIL imports, and each epoch's loss curves where
matplotlib imports (``io/artifacts.py``); EEG samples as ``.npz`` /
``.npy`` arrays (N, C, T), with trace plots and the PSD figure drawn only
where matplotlib is installed. ``RunConfig.debug_nans`` runs a training
loop under autograd's anomaly detection.

Every ``run_*`` loop trains data-parallel across processes
(``RunConfig.mesh``, ``RunConfig.multihost``; ``_start``): the process
group starts from the environment (``parallel/launch.py``), the mesh is
laid over the world and must cover it, every rank builds the same loader
from the same seed and stages the same global batch, and moves only its
rows (``Mesh.rows``) to its card; parameters are broadcast from rank 0
after the init or the resume, validation sums each rank's true rows and
all-reduces the sums, and only rank 0 writes the log, the grids, the
profiler trace and the checkpoints (the others wait at a barrier after a
save; every rank reads on resume). A checkpoint holds the same state
whatever the world size, so a run resumes on any. Three families take a
model axis, as in JAX: ``run_diffusion`` (sequence parallelism),
``run_glow`` (pipeline parallelism with ``GlowConfig.pp_stages``, else
tensor parallelism) and ``run_glow_eeg`` (tensor parallelism); the others
refuse one. Under tensor parallelism each rank holds its shard of the
coupling filters: the full state is initialised or loaded the same way on
every rank and then cut, a checkpoint holds the state gathered from the
model group (every rank gathers, rank 0 writes), and every rank of the
model group runs the sample grid's reverse (rank 0 writes it).
Evaluations and ``sample_from_dir`` run in one process, as in the JAX
package.

The epoch-driven loops (``run_vaegan``, ``run_vae``, ``run_gan``,
``run_diffusion``) train either through the streaming epoch scan
(``_stream_epoch_scan``, JAX's default for the VAE-GAN and DDPM, and
``epoch_scan=True`` for the others, ``SCAN_DEFAULT``) or step by step over
staged batches. Both take their input from the run's ``_Staging``: each
step's rows gathered by the native gather (``data/native.py``) straight
into a ring of pinned buffers and copied to the card from there
(``utils/prefetch.py``), a buffer refilled only after its copy has
completed. The scan stages chunks of batches (``_chunk_steps``: at most
SCAN_CHUNK_BYTES and a quarter of the epoch), gathers and copies the next
chunk while the device runs this one, and runs each chunk through the
run's one ``common.StepGraph`` of the trainer's ``train_step``, made after
init or resume: on a card every step after the warm-up is one replay of
the step captured as a CUDA graph, on the CPU the step itself. Both paths
take the same draws in the same order and log the mean over every step of
the epoch, so on the CPU they give the same bits. On a card two things cannot
be captured: a group that moves CUDA tensors through the host (gloo), and
``--debug-nans``'s anomaly mode, which reads every backward result on the
host. With either, an explicit ``epoch_scan=True`` raises, and the default
falls back to the per-step loop with a line on stderr.
"""
from __future__ import annotations

import functools
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vgd_tpu_torch.core.config import (DiffusionConfig, GANConfig,
                                       GlowConfig, GlowEEGConfig, VAEConfig,
                                       VAEGANConfig, to_dict)
from vgd_tpu_torch.core.rng import resolve_device, seed_all
from vgd_tpu_torch.data import native
from vgd_tpu_torch.data.celeba import make_image_datasets
from vgd_tpu_torch.data.corrupt import corrupt, corrupt_draws
from vgd_tpu_torch.data.eeg import CHANNEL_NAMES, EEGDataset, eeg_batches
from vgd_tpu_torch.eval.eeg_downstream import mean_central_psd
from vgd_tpu_torch.eval.metrics import (MetricAccumulator, mse_metric, psnr,
                                        ssim)
from vgd_tpu_torch.eval.sampling import aggregated_posterior_sampler
from vgd_tpu_torch.eval.vae_analysis import (denoise_test_loss,
                                             latent_traversal, renoise_cycle)
from vgd_tpu_torch.io.artifacts import (MetricLog, epoch_metrics, save_grid,
                                        save_triplets)
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.models.glow import TP_KERNELS
from vgd_tpu_torch.models.vae import reparameterize
from vgd_tpu_torch.ops.image import signed_to_unit, to_signed
from vgd_tpu_torch.parallel.collectives import (all_sum, barrier,
                                                broadcast_, staged)
from vgd_tpu_torch.parallel.launch import init_distributed, rank_device
from vgd_tpu_torch.parallel.mesh import Mesh, build_mesh
from vgd_tpu_torch.parallel.tensor_parallel import check_filters, split_axis
from vgd_tpu_torch.train.common import StepGraph
from vgd_tpu_torch.train.diffusion import (DiffusionState, DiffusionTrainer,
                                           q_sample)
from vgd_tpu_torch.train.gan import GANTrainer
from vgd_tpu_torch.train.glow import GlowEEGTrainer, GlowTrainer
from vgd_tpu_torch.train.vae import VAETrainer
from vgd_tpu_torch.train.vaegan import VAEGANTrainer
from vgd_tpu_torch.utils.prefetch import (PinnedRing, device_prefetch,
                                          fill_chunk, stage_chunks)
from vgd_tpu_torch.utils.viz import have_matplotlib, plot_eeg_signals, \
    save_gif

# offset of the validation generator's seed from the run seed: every epoch
# scores the same t and noise draws, as the JAX loop folds a fixed
# 30_000 + j into its key for val batch j
VAL_SEED_OFFSET = 30_000
# the VAE-GAN loop's fixed grid latents and validation draws, likewise from
# fixed offsets (the JAX loop folds 7 and 10_000 + j into its key)
FIXED_Z_SEED_OFFSET = 7
VAEGAN_VAL_SEED_OFFSET = 10_000
# the VAE loop's validation draws (the JAX loop folds 20_000 + j)
VAE_VAL_SEED_OFFSET = 20_000
# the EEG PSD comparison's temperature z (the JAX function folds 3)
EEG_PSD_SEED_OFFSET = 3


def _debug_nans(run):
    """Runs ``run(cfg, ...)`` under ``torch.autograd.set_detect_anomaly``
    when ``cfg.run.debug_nans`` is set (the counterpart of the JAX loop's
    ``jax_debug_nans``: a backward that makes a NaN raises, naming the
    forward op that made it). Its host reads cannot be captured, so on a
    card the epoch loops train step by step under it (``_epoch_scan``)."""
    @functools.wraps(run)
    def wrapped(cfg, *args, **kwargs):
        if not cfg.run.debug_nans:
            return run(cfg, *args, **kwargs)
        with torch.autograd.set_detect_anomaly(True):
            return run(cfg, *args, **kwargs)
    return wrapped


# --mesh-model on a family without a model-axis consumer (the JAX loop's
# words)
NO_MODEL_CONSUMER = (
    "--mesh-model {} has no effect for this family: its parameters "
    "replicate, so a model axis duplicates all compute without speedup. "
    "Model-axis consumers are 'glow' / 'glow-eeg' (tensor-parallel coupling "
    "filters) and 'diffusion' (ring-attention sequence parallelism); use "
    "--mesh-data for data parallelism here.")
# the families with a model-axis consumer
MODEL_AXIS_FAMILIES = ("diffusion", "glow", "glow-eeg")


def _start(cfg, device, batch_size: int, family: str):
    """(device, generator, mesh) of a training loop: refuses a model axis
    the family cannot use (``MODEL_AXIS_FAMILIES`` have a consumer),
    starts the process group the environment describes
    (``parallel.launch.init_distributed``), puts this rank on its card,
    lays the mesh over the world (it must cover it) and checks that the
    data axis divides the global batch."""
    run = cfg.run
    if run.mesh.model > 1 and family not in MODEL_AXIS_FAMILIES:
        raise ValueError(NO_MODEL_CONSUMER.format(run.mesh.model))
    device = resolve_device(device)
    init_distributed(run.multihost, device)
    device = rank_device(device)
    mesh = build_mesh(run.mesh.data, run.mesh.model)
    if batch_size % mesh.data:
        raise ValueError(f"batch {batch_size} is not divisible by the data "
                         f"axis ({mesh.data}): every rank takes batch / data "
                         f"rows")
    return device, seed_all(run.seed, device), mesh


def _replicate(*modules: torch.nn.Module) -> None:
    """Every parameter and buffer overwritten with rank 0's (no-op in one
    process): the ranks start from one state whatever their inits did."""
    broadcast_([t for mod in modules for t in mod.state_dict().values()])


def _replicate_glow(trainer, mesh: Mesh) -> None:
    """``_replicate`` for a Glow trainer: under tensor parallelism the
    replicated leaves from rank 0 and each shard from the first rank of its
    data group (the ranks that hold the same shard)."""
    if trainer.parallel != "tp":
        _replicate(trainer.model)
        return
    state = trainer.model.state_dict()
    broadcast_([t for k, t in state.items() if split_axis(k) is None])
    if mesh.data_group is not None:
        broadcast_([t for k, t in state.items() if split_axis(k) is not None],
                   mesh.data_group, src=mesh.m)


def _save_glow(mesh: Mesh, ckpt: Checkpointer, trainer, cfg, gen,
               step: int) -> None:
    """A Glow checkpoint of the full state (``checkpoint_state``: every
    rank takes part in the gather), written by rank 0."""
    params, opt_state = trainer.checkpoint_state()
    _save(mesh, ckpt, step, params, to_dict(cfg), opt_state=opt_state,
          rng_state=gen.get_state(), opt_step=trainer.step)


def _check_model_axis(cfg, mesh: Mesh) -> None:
    """JAX's refusals of a Glow model axis, before any work: a pipeline
    that does not fit the mesh, and tensor parallelism with a coupling
    kernel or with filters the model axis does not divide."""
    pp = getattr(cfg, "pp_stages", 0)
    if pp == 0 and mesh.model > 1:
        if getattr(cfg, "fused_coupling", False) or \
                getattr(cfg, "flow_stack", False):
            raise ValueError(TP_KERNELS)
        check_filters(cfg.filter_size, mesh.model)
    if pp > 0:
        if mesh.model != cfg.pp_stages:
            raise ValueError(
                f"--pp-stages {cfg.pp_stages} needs a mesh whose model axis "
                f"has exactly that many devices (have {mesh.model}); pass "
                f"--mesh-model {cfg.pp_stages} or leave it unset (the CLI "
                "sizes it automatically) and provide enough devices")
        if cfg.n_flows % cfg.pp_stages != 0:
            raise ValueError(f"n_flows={cfg.n_flows} must divide evenly "
                             f"over --pp-stages {cfg.pp_stages}")


def _save(mesh: Mesh, ckpt: Checkpointer, *args, **kwargs) -> None:
    """Rank 0 writes the checkpoint; every rank waits for it."""
    if mesh.primary:
        ckpt.save(*args, **kwargs)
    barrier()


def _global_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the data axis of each rank's sum over its true rows
    (a model axis's replicas, which hold the same rows, averaged)."""
    return all_sum(t, mesh.grad_group) / mesh.model


def _val_sums(rows, mesh: Mesh):
    """Per-batch sums over the true rows, summed over the data axis and
    read to the host once: a list of float lists."""
    if not rows:
        return []
    return _global_sum(torch.stack(rows), mesh).double().cpu().tolist()


class _Profiler:
    """``torch.profiler`` trace of global train steps [start, stop) written
    as a Chrome trace into ``RunConfig.profile_dir`` (no-op when unset, and
    on every rank but 0). The per-step loop calls ``step``; the epoch scan,
    which runs whole chunks, calls ``chunk_begin`` / ``chunk_end`` and
    traces every chunk that overlaps [start, stop)."""

    def __init__(self, run_cfg, device: torch.device, enabled: bool = True):
        self.dir = run_cfg.profile_dir if enabled else None
        self.start_step, self.stop_step = run_cfg.profile_steps
        self.device = device
        self.prof = None

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def step(self, i: int) -> None:
        if not self.dir:
            return
        if i == self.start_step and self.prof is None:
            self._start()
        elif i == self.stop_step:
            self.close()

    def chunk_begin(self, lo: int, hi: int) -> None:
        """Before a chunk of global steps [lo, hi): starts the trace when
        the chunk overlaps [start, stop)."""
        if (self.dir and self.prof is None and lo < self.stop_step
                and hi > self.start_step):
            self._start()

    def chunk_end(self, hi: int) -> None:
        """After a chunk ending at global step ``hi``: once the chunks
        reach ``stop``, waits for the card (only while a trace is live, so
        the staging overlap is kept otherwise) and writes the trace."""
        if self.prof is not None and hi >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.dir, f"trace_steps_{self.start_step}_{self.stop_step}.json"))
        self.prof = None


def _image_shape(cfg):
    return tuple(cfg.data.image_size) + (cfg.data.channels,)


# ---------------------------------------------------------------------------
# the streaming epoch scan (vgd_tpu/train/loop.py:245-305)
# ---------------------------------------------------------------------------

# streaming epoch scan: host-stage at most this many bytes of uint8 batches
# per chunk (one chunk in flight + one being staged, so peak extra host
# memory is ~2 chunks instead of a full second copy of the epoch)
SCAN_CHUNK_BYTES = 256 * 1024 ** 2
# the epoch loop each family takes when ``epoch_scan`` is None (JAX's
# defaults: the scan for the VAE-GAN and DDPM, the per-step loop for the
# VAE and DCGAN / WGAN, per JAX's measured A/B)
SCAN_DEFAULT = {"vaegan": True, "diffusion": True, "vae": False,
                "gan": False, "wgan": False}


def _chunk_steps(batch_size: int, img_shape, steps_per_epoch: int) -> int:
    """Steps per scan chunk: under the SCAN_CHUNK_BYTES budget AND at most a
    quarter of the epoch, so there are >= ~4 chunks per epoch and the host
    stages the next chunk while the device runs this one."""
    batch_bytes = batch_size * int(np.prod(img_shape))
    budget = SCAN_CHUNK_BYTES // max(batch_bytes, 1)
    quarter = -(-steps_per_epoch // 4)   # ceil
    return max(1, min(steps_per_epoch, budget, quarter))


# staged transfers in flight (``stage_chunks``): the per-step loop's, and
# the scan's, which stages chunk i + 1 while the device runs chunk i (as
# JAX's streaming scan does), so one chunk is staged before the first
# replay
STEP_PREFETCH, SCAN_PREFETCH = 2, 1


class _Staging:
    """A run's input staging: each step's rows (``Mesh.rows`` of the
    loader's sorted selection: this rank's part of the global batch)
    gathered by the native gather straight into the buffers of one
    ``PinnedRing`` (``utils/prefetch.py``), made once a run: buffers of
    ``per_slot`` batches (the scan's chunk; 1 for the per-step loop), one
    more than the ``prefetch`` transfers in flight, each refilled only
    after its last copy to the card has completed. Where a chunk's gather
    takes threads, their library is built here, in the run's set-up, and
    not in the first chunk's fill."""

    def __init__(self, data: np.ndarray, batch_size: int, mesh: Mesh, device,
                 per_slot: int, prefetch: int):
        lo, hi = mesh.bounds(batch_size)
        self.data, self.mesh, self.prefetch = data, mesh, prefetch
        self.ring = PinnedRing((per_slot, hi - lo) + data.shape[1:],
                               device, slots=prefetch + 1)
        if native.threads_for(self.ring.buffers[0].numel()) > 1:
            native.build()

    def fill(self, data: np.ndarray, sels, buf: torch.Tensor) -> None:
        fill_chunk(data, sels, buf)

    def chunks(self, selections, steps: Optional[int] = None):
        """Device chunks (k, rows, ...) of up to ``per_slot`` steps of
        ``selections``, at most ``steps`` in all."""
        return stage_chunks(self.data, selections, self.ring, steps,
                            self.mesh.rows, self.fill, self.prefetch)

    def batches(self, selections, steps: Optional[int] = None):
        """Device batches (rows, ...) of ``selections``, one a buffer."""
        return (c[0] for c in self.chunks(selections, steps))


def _staging(train, mesh: Mesh, device, scan: bool, steps: int) -> _Staging:
    """The run's staging: chunks of ``_chunk_steps`` for the scan, single
    batches for the per-step loop."""
    if not scan:
        return _Staging(train.ds.array, train.batch_size, mesh, device, 1,
                        STEP_PREFETCH)
    return _Staging(train.ds.array, train.batch_size, mesh, device,
                    _chunk_steps(train.batch_size, train.ds.image_shape,
                                 steps), SCAN_PREFETCH)


def _stream_epoch_scan(graph, chunks, prof, gstep: int):
    """The streaming epoch scan of one epoch: each device chunk of stacked
    batches (``_Staging.chunks``: the next chunk is gathered and its copy
    enqueued while the device runs this one) run by ``graph.run(chunk)``
    (a ``common.StepGraph``); the metrics are read once, after the loop
    (``graph.read()``). Returns (sums, count, gstep): ``sums`` the metrics
    summed over every step (divide by ``count`` for the epoch mean)."""
    count = 0
    for cur in chunks:
        n = cur.shape[0]
        prof.chunk_begin(gstep, gstep + n)
        graph.run(cur)
        count += n
        gstep += n
        prof.chunk_end(gstep)
    return (graph.read() if count else {}), count, gstep


def _epoch_scan(family: str, epoch_scan: Optional[bool], mesh: Mesh,
                device: torch.device, debug_nans: bool = False) -> bool:
    """Whether a run takes the epoch scan, and the line that says so:
    ``epoch_scan`` as given, None -> ``SCAN_DEFAULT[family]``. On a card a
    group that stages tensors through the host, and ``debug_nans``'s
    anomaly mode (a host read of every backward result), cannot be
    captured: an explicit True raises, the default takes the per-step
    loop."""
    cuda = device.type == "cuda"
    if cuda and any(staged(g) for g in (mesh.data_group, mesh.model_group,
                                        mesh.world_group)):
        why = ("a gloo process group moves CUDA tensors through host "
               "memory", "or use NCCL",
               "a gloo group's host-staged collectives")
    elif cuda and debug_nans:
        why = ("--debug-nans's anomaly mode reads every backward result on "
               "the host", "or drop --debug-nans", "--debug-nans's host reads")
    else:
        why = None
    scan = SCAN_DEFAULT[family] if epoch_scan is None else epoch_scan
    if scan and why is not None:
        if epoch_scan:
            raise ValueError(
                f"the epoch scan captures each train step in a CUDA graph, "
                f"and {why[0]}, which a graph cannot capture: pass "
                f"--no-epoch-scan (epoch_scan=False), {why[1]}")
        print(f"[{family}] the epoch scan cannot capture {why[2]}: "
              "training step by step", file=sys.stderr)
        scan = False
    if mesh.primary:
        how = ("each step after the warm-up one CUDA graph replay"
               if cuda else "each step called directly")
        print(f"[{family}] epoch loop: " + (
            f"scan ({how})" if scan else "per step" + (
                "" if epoch_scan is False else " (the family's default)")))
    return scan


def _train_epoch(graph: Optional[StepGraph], staging: _Staging, train,
                 steps: int, prof, gstep: int, step_fn):
    """One epoch's ``steps`` train steps over ``train``'s batches staged by
    ``staging``, through the epoch scan (``graph``, the run's StepGraph of
    ``step_fn``) or, with no graph, step by step (``step_fn`` on each
    batch, the metrics summed on the device and read once). Returns (sums,
    count, gstep) as ``_stream_epoch_scan`` does."""
    selections = (sel for sel, _ in train.selections())
    if graph is not None:
        return _stream_epoch_scan(graph, staging.chunks(selections, steps),
                                  prof, gstep)
    sums, count = {}, 0
    for batch in staging.batches(selections, steps):
        prof.step(gstep)
        m = step_fn(batch)
        gstep += 1
        count += 1
        sums = {k: v + sums[k] if k in sums else v for k, v in m.items()}
    return {k: float(v) for k, v in sums.items()}, count, gstep


def _steps_per_epoch(train, max_steps_per_epoch: Optional[int]) -> int:
    n = len(train)
    return n if max_steps_per_epoch is None else min(n, max_steps_per_epoch)


def restore_trainer(cfg: DiffusionConfig, step: Optional[int] = None,
                    device="cuda") -> DiffusionTrainer:
    """A trainer on ``device`` with the latest (or given) checkpoint of
    ``<out_dir>/ckpt`` loaded."""
    trainer = DiffusionTrainer(cfg, _image_shape(cfg), device=device)
    params, s, _ = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt")).restore(
        step, map_location=trainer.device)
    trainer.load(DiffusionState(params=params))
    print(f"[checkpoint] restored step {s}")
    return trainer


def save_checkpoint(cfg: DiffusionConfig, trainer: DiffusionTrainer,
                    step: int) -> str:
    """Write the trainer's parameters as ``<out_dir>/ckpt`` step ``step``."""
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    return ckpt.save(step, trainer.model.state_dict(), to_dict(cfg))


@_debug_nans
def run_diffusion(cfg: DiffusionConfig, epochs: Optional[int] = None,
                  max_steps_per_epoch: Optional[int] = None,
                  resume: bool = False, device="cuda",
                  epoch_scan: Optional[bool] = None) -> Dict:
    """Train DDPM: per epoch, train steps through the epoch scan (the
    default) or over staged batches with ``epoch_scan=False``
    (module docstring; the loss summed on the device and read once), the
    validation
    epsilon-MSE over the true rows of every val batch, a ``MetricLog`` row
    (train_loss, val_loss, images_per_sec) and, every
    ``checkpoint_every_epochs``, a checkpoint of params, Adam state and the
    generator state at step = epochs done. ``resume`` continues from the
    latest checkpoint exactly: same parameters, moments, draws and batch
    order as a run that never stopped."""
    device, gen, mesh = _start(cfg, device, cfg.data.batch_size,
                               "diffusion")
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = DiffusionTrainer(cfg, img_shape, device=device, mesh=mesh)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(DiffusionState(params=payload["params"],
                                    opt_state=payload["opt_state"],
                                    step=payload["opt_step"]))
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    _replicate(trainer.model)
    log = MetricLog(cfg.run.out_dir, "diffusion_loss")
    prof = _Profiler(cfg.run, device, mesh.primary)
    epochs = cfg.epochs if epochs is None else epochs
    scan = _epoch_scan("diffusion", epoch_scan, mesh, device,
                       cfg.run.debug_nans)
    steps = _steps_per_epoch(train, max_steps_per_epoch)
    staging = _staging(train, mesh, device, scan, steps)

    def step_fn(b):
        return {"loss": trainer.train_step(b, gen)}
    graph = StepGraph(step_fn, trainer, gen) if scan else None
    gstep, n_val = trainer.step, 0
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        sums, count, gstep = _train_epoch(
            graph, staging, train, steps, prof, gstep, step_fn)
        total = sums.get("loss", 0.0)
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)
        vgen = torch.Generator(device=device).manual_seed(
            cfg.run.seed + VAL_SEED_OFFSET)
        val_dev, n_val = torch.zeros((), device=device), 0
        for vbatch, n_valid in val.epoch():
            vl = trainer.eval_loss(torch.from_numpy(mesh.rows(vbatch)), vgen)
            # the padded repeats of a final batch must not count
            val_dev = val_dev + vl[:mesh.valid_rows(n_valid,
                                                    len(vbatch))].sum()
            n_val += n_valid
        train_loss = total / max(count, 1)
        val_loss = float(_global_sum(val_dev, mesh)) / max(n_val, 1)
        log.append(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                   images_per_sec=ips)
        print(f"[diffusion] epoch {epoch + 1}/{epochs} train={train_loss:.4f}"
              f" val={val_loss:.4f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            _save(mesh, ckpt, epoch + 1, trainer.model.state_dict(),
                  to_dict(cfg), opt_state=trainer.opt.state_dict(),
                  rng_state=gen.get_state(), opt_step=trainer.step)
        epoch_metrics(log, "diffusion_")
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def evaluate_diffusion(cfg: DiffusionConfig, trainer: DiffusionTrainer, val,
                       feature_fn=None, max_batches: Optional[int] = None,
                       save_panels: bool = True) -> Dict[str, float]:
    """Restoration evaluation: noise each val batch to a seeded random
    start step, run the ancestral chain back, and score on [0, 1] images
    over the true rows (padded repeats of the last batch excluded): SSIM
    (and, with ``feature_fn``, FID / IS / P-R) through
    ``MetricAccumulator`` and PSNR, as the reference returns them, and MSE
    beside them. With
    ``save_panels`` the first batch's original / noisy / multi-step /
    one-step panel is saved as ``diffusion_restore_panel.npy``."""
    gen = seed_all(cfg.run.seed, trainer.device)
    dev = trainer.device
    acc = MetricAccumulator(feature_fn=feature_fn)
    psnr_sum, mse_sum, n_b = 0.0, 0.0, 0
    for j, (vbatch, n_valid) in enumerate(val.epoch()):
        if max_batches is not None and j >= max_batches:
            break
        x0 = to_signed(torch.from_numpy(vbatch).to(dev))
        # batch-wide random start step, as the reference takes ts[0]
        t_start = int(torch.randint(0, cfg.timesteps, (), generator=gen,
                                    device=dev))
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        t_vec = torch.full((x0.shape[0],), t_start, dtype=torch.int32,
                           device=dev)
        xt = q_sample(trainer.sched, x0, t_vec, noise)
        restored = trainer.ancestral_sample(xt, t_start, generator=gen)
        fake_unit = signed_to_unit(restored)[:n_valid]
        real_unit = signed_to_unit(x0)[:n_valid]
        acc.update(fake_unit, real_unit)
        psnr_sum += float(psnr(fake_unit, real_unit)) * n_valid
        mse_sum += float(mse_metric(fake_unit, real_unit)) * n_valid
        n_b += n_valid
        if save_panels and j == 0:
            one_step = trainer.predict_x0(xt, t_vec)
            n_show = min(4, x0.shape[0])
            panel = torch.stack([x0, torch.clamp(xt, -1, 1), restored,
                                 one_step])[:, :n_show]
            os.makedirs(cfg.run.out_dir, exist_ok=True)
            np.save(os.path.join(cfg.run.out_dir,
                                 "diffusion_restore_panel.npy"),
                    panel.float().cpu().numpy())
    out = acc.compute()
    out.update(psnr=psnr_sum / max(n_b, 1), mse=mse_sum / max(n_b, 1))
    return out


def evaluate_diffusion_from_dir(cfg: DiffusionConfig, feature_fn=None,
                                max_batches: Optional[int] = None,
                                step: Optional[int] = None,
                                device="cuda") -> Dict[str, float]:
    """Restore the latest (or given) DDPM checkpoint and run the
    restoration evaluation on the val split."""
    device = resolve_device(device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_trainer(cfg, step, device)
    out = evaluate_diffusion(cfg, trainer, val, feature_fn=feature_fn,
                             max_batches=max_batches)
    np.savez(os.path.join(cfg.run.out_dir, "diffusion_eval_metrics.npz"),
             **out)
    print("[eval-diffusion] " +
          " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def _restored(trainer, directory: str, step: Optional[int] = None):
    """``trainer`` with the latest (or given) checkpoint under
    ``directory`` loaded (weights and buffers)."""
    params, s, _ = Checkpointer(directory).restore(
        step, map_location=trainer.device)
    trainer.load(params)
    print(f"[checkpoint] restored step {s}")
    return trainer


def restore_vaegan(cfg: VAEGANConfig, step: Optional[int] = None,
                   device="cuda") -> VAEGANTrainer:
    """A VAE-GAN trainer on ``device`` with the latest (or given) checkpoint
    of ``<out_dir>/ckpt`` loaded (weights and BN running stats)."""
    return _restored(VAEGANTrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


@_debug_nans
def run_vaegan(cfg: VAEGANConfig, epochs: Optional[int] = None,
               max_steps_per_epoch: Optional[int] = None,
               feature_fn=None, resume: bool = False, device="cuda",
               epoch_scan: Optional[bool] = None) -> Dict:
    """Train the VAE-GAN: per epoch, ``train_step`` through the epoch scan
    (the default) or over staged batches with
    ``epoch_scan=False`` (module docstring), with the KL ramp of the epoch
    in a 0-d tensor (the losses summed on the device and read once: epoch
    metrics are means over every step), then the denoising validation
    pass over the true rows of every val batch (val loss =
    mean(per_mse[:n]) + alpha_kl * sum(per_kl[:n]), weighted by n; PSNR;
    SSIM, and with ``feature_fn`` FID / IS / P-R, through
    ``MetricAccumulator``), a ``MetricLog`` row, the noisy / clean /
    reconstruction panel and the fixed-z sample grid (``.npy``), and every
    ``checkpoint_every_epochs`` a checkpoint of the three networks (BN
    buffers included), the three Adam states, the optimizer step and the
    generator state at step = epochs done. ``resume`` continues from the
    latest checkpoint exactly."""
    device, gen, mesh = _start(cfg, device, cfg.data.batch_size, "vaegan")
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = VAEGANTrainer(cfg, img_shape, device=device, mesh=mesh)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    _replicate(*trainer.nets().values())
    log = MetricLog(cfg.run.out_dir, "vaegan_loss")
    prof = _Profiler(cfg.run, device, mesh.primary)
    fixed_z = torch.randn(
        (64, cfg.latent_dim), device=device, generator=torch.Generator(
            device=device).manual_seed(cfg.run.seed + FIXED_Z_SEED_OFFSET))
    epochs = cfg.epochs if epochs is None else epochs
    scan = _epoch_scan("vaegan", epoch_scan, mesh, device,
                       cfg.run.debug_nans)
    steps = _steps_per_epoch(train, max_steps_per_epoch)
    staging = _staging(train, mesh, device, scan, steps)
    # the epoch's KL ramp, filled before each epoch: a captured step reads
    # the tensor at every replay
    ramp = torch.zeros((), device=device)

    def step_fn(b):
        return trainer.train_step(b, ramp, gen)
    graph = StepGraph(step_fn, trainer, gen) if scan else None
    gstep, n_val = trainer.step, 0
    od = cfg.run.out_dir
    for epoch in range(start_epoch, epochs):
        ramp.fill_(trainer.kl_ramp(epoch))
        t0 = time.perf_counter()
        sums, count, gstep = _train_epoch(
            graph, staging, train, steps, prof, gstep, step_fn)
        means = {f"train_{k}": v / count for k, v in sums.items()}
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)

        tv0 = time.perf_counter()
        acc = MetricAccumulator(feature_fn=feature_fn, group=mesh.data_group)
        vgen = torch.Generator(device=device).manual_seed(
            cfg.run.seed + VAEGAN_VAL_SEED_OFFSET)
        rows, ns, panel = [], [], None
        for vbatch, n in val.epoch():
            vb = torch.from_numpy(mesh.rows(vbatch)).to(device)
            ev = trainer.eval_step(vb, vgen)
            img = to_signed(vb)
            recon_u, img_u = signed_to_unit(ev["recon"]), signed_to_unit(img)
            # only the true rows of a padded final batch count
            k = mesh.valid_rows(n, len(vbatch))
            acc.update(recon_u, img_u, n_valid=k)
            rows.append(torch.stack([
                ev["per_mse"][:k].sum(), ev["per_kl"][:k].sum(),
                psnr(recon_u[:k], img_u[:k]) * k]) if k else
                torch.zeros(3, device=device))
            ns.append(n)
            if panel is None:
                panel = (ev["noisy"], img, ev["recon"])
        n_val = sum(ns)
        vals = _val_sums(rows, mesh)
        val_loss = sum((mse_ / n + cfg.alpha_kl * kl_) * n
                       for (mse_, kl_, _), n in zip(vals, ns))
        metrics = acc.compute()
        metrics["psnr"] = sum(p for _, _, p in vals) / max(n_val, 1)
        row = dict(means, val_loss=val_loss / max(n_val, 1),
                   images_per_sec=ips, val_secs=time.perf_counter() - tv0,
                   **metrics)
        log.append(epoch=epoch, **row)
        print(f"[vaegan] epoch {epoch + 1}/{epochs} "
              f"recon={row.get('train_recon', 0):.4f} "
              f"val={row['val_loss']:.4f} ssim={metrics['ssim']:.4f} "
              f"psnr={metrics['psnr']:.2f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            _save(mesh, ckpt, epoch + 1, trainer.state_dict(), to_dict(cfg),
                  opt_state=trainer.opt_state(), rng_state=gen.get_state(),
                  opt_step=trainer.step)
        if mesh.primary:
            if panel is not None:  # the val split can be empty on tiny data
                save_triplets(*panel, os.path.join(
                    od, f"vaegan_decode_epoch_{epoch + 1:04d}.npy"))
            save_grid(trainer.generate(fixed_z), os.path.join(
                od, f"vaegan_fake_epoch_{epoch + 1:04d}.npy"))
        epoch_metrics(log)
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def restore_vae(cfg: VAEConfig, step: Optional[int] = None,
                device="cuda") -> VAETrainer:
    """A VAE trainer on ``device`` with the latest (or given) checkpoint of
    ``<out_dir>/ckpt`` loaded (weights and BN running stats)."""
    return _restored(VAETrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


@_debug_nans
def run_vae(cfg: VAEConfig, epochs: Optional[int] = None,
            max_steps_per_epoch: Optional[int] = None, resume: bool = False,
            device="cuda", epoch_scan: Optional[bool] = None) -> Dict:
    """Train the denoising VAE: per epoch, ``train_step`` over
    staged batches (the default) or through the epoch scan
    with ``epoch_scan=True`` (module docstring), with the KL ramp of the
    epoch in a 0-d tensor (the loss summed on the device and read once),
    then the random-std denoising
    validation over the true rows of every val batch (val loss = mean(
    per_mse[:n]) + sum(per_kl[:n]), weighted by n; MSE, PSNR and SSIM of
    the [0, 1] reconstructions, each weighted by n), a ``MetricLog`` row,
    the noisy / clean / reconstruction panel and the fixed-z grid
    (``.npy``), and every ``checkpoint_every_epochs`` a checkpoint of both
    networks (BN buffers included), the Adam state, the optimizer step and
    the generator state at step = epochs done. ``resume`` continues from
    the latest checkpoint exactly."""
    device, gen, mesh = _start(cfg, device, cfg.data.batch_size, "vae")
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = VAETrainer(cfg, img_shape, device=device, mesh=mesh)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    _replicate(*trainer.nets().values())
    log = MetricLog(cfg.run.out_dir, "vae_loss")
    prof = _Profiler(cfg.run, device, mesh.primary)
    fixed_z = torch.randn(
        (64, cfg.latent_dim), device=device, generator=torch.Generator(
            device=device).manual_seed(cfg.run.seed + FIXED_Z_SEED_OFFSET))
    epochs = cfg.epochs if epochs is None else epochs
    scan = _epoch_scan("vae", epoch_scan, mesh, device, cfg.run.debug_nans)
    steps = _steps_per_epoch(train, max_steps_per_epoch)
    staging = _staging(train, mesh, device, scan, steps)
    ramp = torch.zeros((), device=device)

    def step_fn(b):
        return {"total": trainer.train_step(b, ramp, generator=gen)["total"]}
    graph = StepGraph(step_fn, trainer, gen) if scan else None
    gstep, n_val = trainer.step, 0
    od = cfg.run.out_dir
    for epoch in range(start_epoch, epochs):
        ramp.fill_(trainer.kl_ramp(epoch))
        t0 = time.perf_counter()
        sums, count, gstep = _train_epoch(
            graph, staging, train, steps, prof, gstep, step_fn)
        total = sums.get("total", 0.0)
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)

        vgen = torch.Generator(device=device).manual_seed(
            cfg.run.seed + VAE_VAL_SEED_OFFSET)
        rows, ns, panel = [], [], None
        for vbatch, n in val.epoch():
            vb = torch.from_numpy(mesh.rows(vbatch)).to(device)
            ev = trainer.eval_step(vb, vgen)
            img = to_signed(vb)
            # only the true rows of a padded final batch count
            k = mesh.valid_rows(n, len(vbatch))
            ru, iu = signed_to_unit(ev["recon"][:k]), signed_to_unit(img[:k])
            rows.append(torch.stack([
                ev["per_mse"][:k].sum(), ev["per_kl"][:k].sum(),
                mse_metric(ru, iu) * k, psnr(ru, iu) * k, ssim(ru, iu) * k])
                if k else torch.zeros(5, device=device))
            ns.append(n)
            if panel is None:
                panel = (ev["noisy"], img, ev["recon"])
        n_val = sum(ns)
        vals = _val_sums(rows, mesh)
        n_b = max(n_val, 1)

        def weighted(j):
            return sum(v[j] for v in vals) / n_b
        row = dict(train_loss=total / max(count, 1),
                   val_loss=sum((v[0] / n + v[1]) * n
                                for v, n in zip(vals, ns)) / n_b,
                   images_per_sec=ips, mse=weighted(2), psnr=weighted(3),
                   ssim=weighted(4))
        log.append(epoch=epoch, **row)
        print(f"[vae] epoch {epoch + 1}/{epochs} train={row['train_loss']:.4f}"
              f" val={row['val_loss']:.4f} psnr={row['psnr']:.2f} "
              f"ssim={row['ssim']:.4f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            _save(mesh, ckpt, epoch + 1, trainer.state_dict(), to_dict(cfg),
                  opt_state=trainer.opt.state_dict(),
                  rng_state=gen.get_state(), opt_step=trainer.step)
        if mesh.primary:
            if panel is not None:  # the val split can be empty on tiny data
                save_triplets(*panel, os.path.join(
                    od, f"vae_valimg_epoch_{epoch + 1:04d}.npy"))
            save_grid(trainer.generate(fixed_z), os.path.join(
                od, f"vae_fake_epoch_{epoch + 1:04d}.npy"))
        epoch_metrics(log, "vae_")
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def evaluate_vae_checkpoints(cfg: VAEConfig, feature_fn=None,
                             max_checkpoints: Optional[int] = None,
                             max_encode_batches: Optional[int] = None,
                             max_eval_batches: Optional[int] = None,
                             device="cuda") -> list:
    """Aggregated-posterior sweep: for every saved checkpoint (the last
    ``max_checkpoints``), encode the train and val splits (at most
    ``max_encode_batches`` batches of each), build per-dimension empirical
    CDFs of (mu, logvar), inverse-transform sample one batch per val batch,
    reparameterize (eps from a generator seeded from the run seed, the same
    draws for every checkpoint), decode, and score SSIM (and, with
    ``feature_fn``, FID / IS / P-R) against the val batch over its true
    rows. Saves one grid per checkpoint
    (``vae_aggpost_step_<s>.npy``) and ``vae_eval_metrics.npz``."""
    device = resolve_device(device)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = VAETrainer(cfg, img_shape, device=device)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"))
    steps = ckpt.all_steps()
    if max_checkpoints:
        steps = steps[-max_checkpoints:]

    @torch.no_grad()
    def encode(batch_uint8):      # raw (mu, logvar), as the JAX sweep's
        return trainer.encoder(to_signed(torch.from_numpy(batch_uint8).to(
            device)), train=False)
    results = []
    for s in steps:
        _restored(trainer, ckpt.directory, s)
        sampler = aggregated_posterior_sampler(
            encode, [train, val], seed=cfg.run.seed,
            max_batches=max_encode_batches)
        gen = torch.Generator(device=device).manual_seed(cfg.run.seed)
        acc, grid = MetricAccumulator(feature_fn=feature_fn), None
        for j, (vbatch, n_valid) in enumerate(val.epoch()):
            if max_eval_batches is not None and j >= max_eval_batches:
                break
            mu, logvar = (torch.from_numpy(a).to(device)
                          for a in sampler(len(vbatch)))
            z, _ = reparameterize(mu, logvar, torch.randn(
                mu.shape, generator=gen, device=device))
            fake = trainer.generate(z)
            real = to_signed(torch.from_numpy(vbatch).to(device))
            acc.update(signed_to_unit(fake), signed_to_unit(real),
                       n_valid=n_valid)
            if grid is None:
                grid = fake
        row = {"step": s, **acc.compute()}
        results.append(row)
        if grid is not None:
            save_grid(grid, os.path.join(cfg.run.out_dir,
                                         f"vae_aggpost_step_{s:06d}.npy"))
        print(f"[eval-vae] ckpt {s}: " + " ".join(
            f"{k}={v:.4f}" for k, v in row.items() if k != "step"))
    np.savez(os.path.join(cfg.run.out_dir, "vae_eval_metrics.npz"),
             results=np.array([list(r.values()) for r in results]),
             columns=np.array(list(results[0].keys()) if results else []))
    return results


def evaluate_vae_occlusion(cfg: VAEConfig, max_batches: Optional[int] = None,
                           renoise_cycles: int = 2, step: Optional[int] = None,
                           device="cuda") -> Dict[str, float]:
    """Occlusion test: per val batch (true rows only), (occluded + noisy,
    clean) pairs from ``corrupt``, then the latest (or given) checkpoint's
    sum-reduction test loss (averaged over batches) and MSE / PSNR / SSIM
    (weighted by rows); the first batch's noisy / clean / reconstruction
    triplets, re-noise cycles and mu / logvar traversal strips as ``.npy``
    and the metrics as ``occlusion_metrics.npz``. Every draw comes, in
    that order, from the generator seeded with the run seed."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_vae(cfg, step, device)
    sums: Dict[str, float] = {}
    n_b, n_s, first = 0, 0, None
    for j, (vbatch, n_valid) in enumerate(val.epoch()):
        if max_batches is not None and j >= max_batches:
            break
        # the padded repeats go before the corruption
        clean = to_signed(torch.from_numpy(vbatch).to(device))[:n_valid]
        noisy = corrupt(clean, trainer.noise_std,
                        corrupt_draws(clean.shape, gen, device))
        m = denoise_test_loss(trainer, noisy, clean, generator=gen)
        recon = m.pop("recon")
        sums["test_loss"] = sums.get("test_loss", 0.0) + m.pop("test_loss")
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v * n_valid
        n_b += 1
        n_s += n_valid
        if first is None:
            first = (noisy, clean, recon)
    out = {"test_loss": sums.pop("test_loss", 0.0) / max(n_b, 1)}
    out.update({k: v / max(n_s, 1) for k, v in sums.items()})
    if first is None:           # empty val split (tiny datasets)
        return out
    od = cfg.run.out_dir
    save_triplets(*first, os.path.join(od, "occlusion_triplets.npy"))
    cycles = renoise_cycle(trainer, first[0], cycles=renoise_cycles,
                           generator=gen)
    save_triplets(first[0], cycles[0], cycles[-1],
                  os.path.join(od, "occlusion_renoise_cycles.npy"))
    for target in ("mu", "logvar"):
        frames = latent_traversal(trainer, first[0][:1], target=target,
                                  generator=gen)
        save_grid(frames, os.path.join(od,
                                       f"occlusion_traversal_{target}.npy"))
    np.savez(os.path.join(od, "occlusion_metrics.npz"), **out)
    print("[eval-vae --occlusion] " +
          " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def denoise_images(cfg: VAEConfig, ckpt_dir: str, images_uint8: np.ndarray,
                   seed: int = 42, device="cuda") -> np.ndarray:
    """Restore uint8 images (N, H, W, 3) at ``cfg.data.image_size`` with the
    latest VAE checkpoint under ``ckpt_dir``: encode -> reparameterize with
    one eps (1, latent) drawn from ``seed`` and shared by every image ->
    decode, eval mode. Returns uint8 (N, H, W, 3)."""
    trainer = _restored(VAETrainer(cfg, _image_shape(cfg), device=device),
                        ckpt_dir)
    dev = trainer.device
    eps = torch.randn((1, cfg.latent_dim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    out = trainer.denoise(to_signed(torch.from_numpy(
        np.ascontiguousarray(images_uint8)).to(dev)), eps)
    return torch.clamp((out + 1.0) * 127.5, 0, 255).to(torch.uint8).cpu() \
        .numpy()


def restore_gan(cfg: GANConfig, step: Optional[int] = None,
                device="cuda") -> GANTrainer:
    """A DCGAN / WGAN trainer on ``device`` with the latest (or given)
    checkpoint of ``<out_dir>/ckpt`` loaded (weights and BN running
    stats)."""
    return _restored(GANTrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


@_debug_nans
def run_gan(cfg: GANConfig, epochs: Optional[int] = None,
            max_steps_per_epoch: Optional[int] = None, resume: bool = False,
            device="cuda", epoch_scan: Optional[bool] = None) -> Dict:
    """Train DCGAN (or WGAN with ``cfg.wgan``): per epoch, ``train_step``
    (``train_step_wgan``) over staged batches (the default)
    or through the epoch scan with ``epoch_scan=True`` (module docstring;
    both losses summed on the device and read once), a ``MetricLog`` row
    (d_loss, g_loss, images_per_sec), every ``checkpoint_every_epochs`` a
    checkpoint of both networks (BN buffers included), both Adam states, the
    optimizer step and the generator state at step = epochs done, and the
    fixed-z grid (``.npy``). ``resume`` continues from the latest
    checkpoint exactly."""
    name = "wgan" if cfg.wgan else "gan"
    device, gen, mesh = _start(cfg, device, cfg.data.batch_size, name)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = GANTrainer(cfg, img_shape, device=device, mesh=mesh)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    _replicate(*trainer.nets().values())
    log = MetricLog(cfg.run.out_dir, "gan_loss")
    prof = _Profiler(cfg.run, device, mesh.primary)
    fixed_z = torch.randn(
        (64, cfg.latent_dim), device=device, generator=torch.Generator(
            device=device).manual_seed(cfg.run.seed + FIXED_Z_SEED_OFFSET))
    step = trainer.train_step_wgan if cfg.wgan else trainer.train_step
    epochs = cfg.epochs if epochs is None else epochs
    scan = _epoch_scan(name, epoch_scan, mesh, device, cfg.run.debug_nans)
    steps = _steps_per_epoch(train, max_steps_per_epoch)
    staging = _staging(train, mesh, device, scan, steps)

    def step_fn(b):
        return step(b, gen)
    graph = StepGraph(step_fn, trainer, gen) if scan else None
    gstep = trainer.step
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        sums, count, gstep = _train_epoch(
            graph, staging, train, steps, prof, gstep, step_fn)
        means = {k: v / max(count, 1) for k, v in sums.items()}
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)
        log.append(epoch=epoch, **means, images_per_sec=ips)
        print(f"[{name}] epoch {epoch + 1}/{epochs} "
              f"D={means.get('d_loss', 0.0):.4f} "
              f"G={means.get('g_loss', 0.0):.4f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            _save(mesh, ckpt, epoch + 1, trainer.state_dict(), to_dict(cfg),
                  opt_state=trainer.opt_state(), rng_state=gen.get_state(),
                  opt_step=trainer.step)
        if mesh.primary:
            save_grid(trainer.generate(fixed_z), os.path.join(
                cfg.run.out_dir, f"{name}_fake_epoch_{epoch + 1:04d}.npy"))
        epoch_metrics(log, "gan_")
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val}


def evaluate_gan_checkpoints(cfg: GANConfig, feature_fn=None,
                             max_checkpoints: Optional[int] = None,
                             device="cuda") -> list:
    """For every saved checkpoint (the last ``max_checkpoints``), one batch
    of prior samples per val batch (z from a generator seeded from the run
    seed, the same draws for every checkpoint) scored by SSIM (and, with
    ``feature_fn``, FID / IS / P-R) against it over its true rows;
    ``metrics.npz``."""
    device = resolve_device(device)
    _, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = GANTrainer(cfg, img_shape, device=device)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"))
    steps = ckpt.all_steps()
    if max_checkpoints:
        steps = steps[-max_checkpoints:]
    results = []
    for s in steps:
        _restored(trainer, ckpt.directory, s)
        gen = torch.Generator(device=device).manual_seed(cfg.run.seed)
        acc = MetricAccumulator(feature_fn=feature_fn)
        for vbatch, n_valid in val.epoch():
            fake = trainer.generate(torch.randn(
                (len(vbatch), cfg.latent_dim), generator=gen, device=device))
            real = to_signed(torch.from_numpy(vbatch).to(device))
            acc.update(signed_to_unit(fake), signed_to_unit(real),
                       n_valid=n_valid)
        results.append({"step": s, **acc.compute()})
        print(f"[eval-gan] ckpt {s}: " + " ".join(
            f"{k}={v:.4f}" for k, v in results[-1].items() if k != "step"))
    np.savez(os.path.join(cfg.run.out_dir, "metrics.npz"),
             results=np.array([list(r.values()) for r in results]),
             columns=np.array(list(results[0].keys()) if results else []))
    return results


def restore_glow(cfg: GlowConfig, step: Optional[int] = None,
                 device="cuda") -> GlowTrainer:
    """A Glow trainer on ``device`` with the latest (or given) checkpoint of
    ``<out_dir>/ckpt`` loaded."""
    return _restored(GlowTrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


def _glow_steps(trainer, batches, gen: torch.Generator, prof, start: int,
                stop: int, after: Optional[Callable[[int, Dict], None]] = None
                ) -> int:
    """Glow's per-step loop: iterations ``start`` .. ``stop`` - 1, each one
    ``trainer.train_step`` on the next of ``batches`` (the staged device
    batches; the loop ends early where they end) with ``gen``'s draws, then
    ``after(i, metrics)`` (sampling, logging and checkpoints). Returns the
    iterations run."""
    done = 0
    for i in range(start, stop):
        prof.step(i)
        batch = next(batches, None)
        if batch is None:
            break
        m = trainer.train_step(batch, gen)
        done += 1
        if after is not None:
            after(i, m)
    return done


@_debug_nans
def run_glow(cfg: GlowConfig, n_iter: Optional[int] = None,
             resume: bool = False, device="cuda") -> Dict:
    """Train Glow for ``n_iter`` iterations (default ``cfg.n_iter``) on an
    endless shuffled stream: the data-dependent ActNorm init on batch 0,
    then iteration i on batch i + 1 (``_glow_steps``); every
    ``sample_every_iters`` a grid of ``reverse(z_sample) * 2`` (fixed
    temperature z from seed + 7) as ``sample/<iter>.npy`` and a
    ``MetricLog`` row (iter, loss, log_p, logdet, images_per_sec); every
    ``checkpoint_every_iters`` and at the end a checkpoint of the model
    (buffers included), Adam, the generator and the iteration. ``resume``
    continues from the latest checkpoint exactly: same parameters,
    moments, draws and stream position."""
    device, gen, mesh = _start(cfg, device, cfg.data.batch_size, "glow")
    _check_model_axis(cfg, mesh)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = GlowTrainer(cfg, img_shape, device=device, mesh=mesh)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    log = MetricLog(cfg.run.out_dir, "glow_loss")
    prof = _Profiler(cfg.run, device, mesh.primary)
    z_sample = trainer.sample_z(torch.Generator(device=device).manual_seed(
        cfg.run.seed + FIXED_Z_SEED_OFFSET), cfg.n_samples)
    n_iter = cfg.n_iter if n_iter is None else n_iter
    sample_dir = os.path.join(cfg.run.out_dir, "sample")
    start = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start = payload["step"]
        print(f"[checkpoint] resumed at iteration {start}")
    _replicate_glow(trainer, mesh)
    # batch 0 goes to the ActNorm init and batch i + 1 to iteration i, so a
    # run resumed at `start` continues from batch start + 1
    batches = _staging(train, mesh, device, False, 0).batches(
        train.stream_selections(start + 1 if start else 0))
    if start == 0:
        trainer.init_step(next(batches), gen)

    def save(step):
        _save_glow(mesh, ckpt, trainer, cfg, gen, step)
    t0 = time.perf_counter()

    def after(i, m):
        nonlocal t0
        if (i + 1) % cfg.run.sample_every_iters == 0:
            # under tensor parallelism the reverse is collective
            if mesh.primary or trainer.parallel == "tp":
                grid = trainer.reverse(z_sample) * 2.0
                if mesh.primary:
                    save_grid(grid, os.path.join(sample_dir,
                                                 f"{i + 1:06d}.npy"))
            ips = cfg.run.sample_every_iters * cfg.data.batch_size / \
                max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            log.append(iter=i + 1, loss=float(m["loss"]),
                       log_p=float(m["log_p"]), logdet=float(m["logdet"]),
                       images_per_sec=ips)
            print(f"[glow] iter {i + 1}/{n_iter} loss={float(m['loss']):.4f}"
                  f" {ips:.0f} img/s")
        if (i + 1) % cfg.run.checkpoint_every_iters == 0:
            save(i + 1)
    _glow_steps(trainer, batches, gen, prof, start, n_iter, after)
    if ckpt.latest_step() != n_iter:      # always leave a final checkpoint
        save(n_iter)
    prof.close()
    epoch_metrics(log, "glow_")
    return {"trainer": trainer, "log": log.history, "val": val}


def evaluate_glow(cfg: GlowConfig, trainer: GlowTrainer, val,
                  feature_fn=None, max_batches: Optional[int] = None
                  ) -> Dict[str, float]:
    """Temperature samples, one batch per val batch, scored by SSIM (and,
    with ``feature_fn``, FID / IS / P-R) against it: fake in [-0.5, 0.5]
    mapped to clip(fake + 0.5, 0, 1), real uint8 / 255, true rows only."""
    gen = seed_all(cfg.run.seed, trainer.device)
    acc = MetricAccumulator(feature_fn=feature_fn)
    for j, (vbatch, n_valid) in enumerate(val.epoch()):
        if max_batches is not None and j >= max_batches:
            break
        fake = trainer.reverse(trainer.sample_z(gen, len(vbatch)))
        real = torch.from_numpy(vbatch).to(trainer.device).float() / 255.0
        acc.update(torch.clamp(fake + 0.5, 0.0, 1.0), real, n_valid=n_valid)
    return acc.compute()


def evaluate_glow_from_dir(cfg: GlowConfig, feature_fn=None,
                           max_batches: Optional[int] = None,
                           step: Optional[int] = None,
                           device="cuda") -> Dict[str, float]:
    """Restore the latest (or given) Glow checkpoint and run
    ``evaluate_glow`` on the val split."""
    device = resolve_device(device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_glow(cfg, step, device)
    out = evaluate_glow(cfg, trainer, val, feature_fn=feature_fn,
                        max_batches=max_batches)
    np.savez(os.path.join(cfg.run.out_dir, "glow_eval_metrics.npz"), **out)
    print("[eval-glow] " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def load_feature_fn(enabled: bool, weights_path: Optional[str] = None,
                    feature: str = "64", device="cuda"):
    """(feature_fn, tag) of ``eval.inception.load_inception`` on
    ``device`` for FID / IS / P-R, or (None, None) when neither asked for
    nor given weights."""
    if not enabled and weights_path is None:
        return None, None
    from vgd_tpu_torch.eval.inception import load_inception
    return load_inception(weights_path, feature=feature, device=device)


def _eeg_ckpt_dir(cfg: GlowEEGConfig) -> str:
    return os.path.join(cfg.run.out_dir, f"ckpt_{cfg.event_type}")


def restore_glow_eeg(cfg: GlowEEGConfig, step: Optional[int] = None,
                     device="cuda") -> GlowEEGTrainer:
    """An EEG Glow trainer on ``device`` with the latest (or given)
    checkpoint of ``<out_dir>/ckpt_<event_type>`` loaded."""
    return _restored(GlowEEGTrainer(cfg, device=device), _eeg_ckpt_dir(cfg),
                     step)


def _eeg_trials(x: torch.Tensor) -> np.ndarray:
    """(N, T, 1, C) flow samples as (N, C, T) numpy, the reference's dump
    layout."""
    return x[:, :, 0, :].permute(0, 2, 1).float().cpu().numpy()


def sample_eeg(trainer: GlowEEGTrainer, n: int, seed: int = 42
               ) -> np.ndarray:
    """``n`` trials (N, C, T) of the flow at its temperature, z drawn from
    ``seed``."""
    z = trainer.sample_z(seed_all(seed, trainer.device), n)
    return _eeg_trials(trainer.reverse(z))


@_debug_nans
def run_glow_eeg(cfg: GlowEEGConfig, n_iter: Optional[int] = None,
                 resume: bool = False, device="cuda") -> Dict:
    """Train the EEG Glow of one event type for ``n_iter`` iterations
    (default ``cfg.n_iter``) on an endless shuffled stream of the T
    session's trials: the ActNorm init on batch 0, then iteration i on batch
    i + 1; every ``sample_every_iters`` the fixed temperature z's trials as
    ``sample/fake_eeg_<event>_training_<iter>.npz`` (N, C, T), a trace PNG
    of the first where matplotlib is installed, and a ``MetricLog`` row;
    every ``checkpoint_every_iters`` and at the end a checkpoint under
    ``ckpt_<event>`` of the model, Adam, the generator and the iteration.
    ``resume`` continues from the latest checkpoint exactly (parameters,
    moments, draws, stream position). Then ``eeg_psd_and_gif``; a failure
    there is printed and does not undo the finished run."""
    device, gen, mesh = _start(cfg, device, cfg.batch_size, "glow-eeg")
    _check_model_axis(cfg, mesh)
    ds = EEGDataset(path=cfg.eeg_path, dataset_type="T",
                    event_type=cfg.event_type, seed=cfg.run.seed)
    trainer = GlowEEGTrainer(cfg, device=device, mesh=mesh)
    trainer.init(gen)
    ckpt = Checkpointer(_eeg_ckpt_dir(cfg), keep=cfg.run.keep_checkpoints)
    log = MetricLog(cfg.run.out_dir, f"eeg_{cfg.event_type}")
    prof = _Profiler(cfg.run, device, mesh.primary)
    z_sample = trainer.sample_z(torch.Generator(device=device).manual_seed(
        cfg.run.seed + FIXED_Z_SEED_OFFSET), cfg.n_samples)
    n_iter = cfg.n_iter if n_iter is None else n_iter
    sample_dir = os.path.join(cfg.run.out_dir, "sample")
    os.makedirs(sample_dir, exist_ok=True)
    start = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start = payload["step"]
        print(f"[checkpoint] resumed at iteration {start}")
    _replicate_glow(trainer, mesh)
    # batch 0 goes to the ActNorm init and batch i + 1 to iteration i
    batches = device_prefetch(map(mesh.rows, eeg_batches(
        ds, cfg.batch_size, seed=cfg.run.seed,
        skip=start + 1 if start > 0 else 0)), size=2, device=device)
    if start == 0:
        trainer.init_step(next(batches), gen)
    draw = have_matplotlib()
    if not draw and mesh.primary:
        print(f"[glow-eeg:{cfg.event_type}] matplotlib is not installed: "
              f"samples are written as .npz only, no trace PNG")

    def save(step):
        _save_glow(mesh, ckpt, trainer, cfg, gen, step)
    t0 = time.perf_counter()
    for i in range(start, n_iter):
        prof.step(i)
        m = trainer.train_step(next(batches), gen)
        if (i + 1) % cfg.run.sample_every_iters == 0:
            # under tensor parallelism the reverse is collective
            fakes = (trainer.reverse(z_sample)
                     if mesh.primary or trainer.parallel == "tp" else None)
            if mesh.primary:
                arr = _eeg_trials(fakes)
                name = f"fake_eeg_{cfg.event_type}_training_{i + 1}"
                np.savez(os.path.join(sample_dir, f"{name}.npz"), arr)
                if draw:
                    plot_eeg_signals(arr, os.path.join(sample_dir,
                                                       f"{name}.png"),
                                     channel_names=CHANNEL_NAMES)
            tps = cfg.run.sample_every_iters * cfg.batch_size / \
                max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            log.append(iter=i + 1, loss=float(m["loss"]),
                       trials_per_sec=tps)
            print(f"[glow-eeg:{cfg.event_type}] iter {i + 1}/{n_iter} "
                  f"loss={float(m['loss']):.4f} {tps:.0f} trials/s")
        if (i + 1) % cfg.run.checkpoint_every_iters == 0:
            save(i + 1)
    if ckpt.latest_step() != n_iter:      # always leave a final checkpoint
        save(n_iter)
    prof.close()
    epoch_metrics(log, f"eeg_{cfg.event_type}_")
    try:
        if mesh.primary:
            # a sharded trainer's reverse needs its model group: rank 0
            # restores the final (full) checkpoint instead
            eeg_psd_and_gif(cfg, trainer=None if trainer.parallel == "tp"
                            else trainer, dataset=ds, device=device)
    except Exception as e:  # noqa: BLE001 - artifacts, not the run
        print(f"[glow-eeg] post-training artifacts failed: "
              f"{type(e).__name__}: {e}")
    return {"trainer": trainer, "log": log.history}


def eeg_psd_and_gif(cfg: GlowEEGConfig, trainer: Optional[GlowEEGTrainer]
                    = None, dataset: Optional[EEGDataset] = None,
                    n_fake: int = 64, step: Optional[int] = None,
                    device="cuda") -> Dict[str, str]:
    """The real-vs-generated PSD comparison: ``n_fake`` temperature samples
    (z from seed + EEG_PSD_SEED_OFFSET; non-finite trials dropped) against
    the T session's trials, the welch PSD of their C3 / Cz / C4 average as
    ``psd_<event>.npz`` (freq, real, fake, n_real, n_fake) and, where
    matplotlib is installed, ``psd_comparison_<event>.jpg``; and the
    training-evolution GIF of the trace PNGs, where there are any. Restores
    the latest (or given) checkpoint when no trainer is given. Returns the
    paths ("" for what was not drawn)."""
    import glob

    if trainer is None:
        trainer = restore_glow_eeg(cfg, step, device)
    if dataset is None:
        dataset = EEGDataset(path=cfg.eeg_path, dataset_type="T",
                             event_type=cfg.event_type, seed=cfg.run.seed)
    z = trainer.sample_z(torch.Generator(device=trainer.device).manual_seed(
        cfg.run.seed + EEG_PSD_SEED_OFFSET), n_fake)
    fake = _eeg_trials(trainer.reverse(z))
    fake = fake[np.isfinite(fake).all(axis=(1, 2))]
    real = dataset.as_ncT()
    fx, psd_r = mean_central_psd(real)
    _, psd_f = mean_central_psd(fake)
    od, et = cfg.run.out_dir, cfg.event_type
    out = {"psd_npz": os.path.join(od, f"psd_{et}.npz"), "psd": "",
           "gif": ""}
    np.savez(out["psd_npz"], freq=fx, real=psd_r, fake=psd_f,
             n_real=len(real), n_fake=len(fake))
    if have_matplotlib():
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.semilogy(fx, psd_r, label=f"real (n={len(real)})")
        ax.semilogy(fx, psd_f, label=f"generated (n={len(fake)})")
        ax.set_xlabel("frequency [Hz]")
        ax.set_ylabel("PSD")
        ax.set_title(f"central-channel PSD, event '{et}'")
        ax.grid(True, alpha=0.3)
        ax.legend()
        out["psd"] = os.path.join(od, f"psd_comparison_{et}.jpg")
        fig.savefig(out["psd"], bbox_inches="tight", dpi=90)
        plt.close(fig)
    frames = sorted(
        glob.glob(os.path.join(od, "sample",
                               f"fake_eeg_{et}_training_*.png")),
        key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    if frames:
        out["gif"] = os.path.join(od, f"training_evolution_{et}.gif")
        save_gif(frames, out["gif"])
    print(f"[eval-eeg] psd={out['psd_npz']} figure={out['psd'] or '(none)'} "
          f"gif={out['gif'] or '(no frames)'}")
    return out


def sample_from_dir(family: str, cfg, n: int = 64,
                    out_path: Optional[str] = None,
                    step: Optional[int] = None, seed: int = 42,
                    ddim_steps: int = 0, ddim_eta: float = 0.0,
                    device="cuda") -> str:
    """Generate samples from a trained checkpoint; writes an (n, H, W, C)
    ``.npy`` in [-1, 1] (EEG: (n, C, T) trials, and a trace PNG of the
    first where matplotlib is installed) and returns its path.
    ``diffusion``: the DDIM chain (``ddim_steps > 0``) or the full
    ancestral chain from noise drawn from ``seed``; ``glow``: the reverse
    flow on temperature z drawn from ``seed``, times 2 (images in
    [-1, 1]); ``glow-eeg``: the reverse flow of ``ckpt_<event_type>`` on
    temperature z drawn from ``seed``; ``vaegan``, ``vae``, ``gan``,
    ``wgan``: the decoder / generator in eval mode on z (n, latent) drawn
    from ``seed``."""
    restore = {"vaegan": restore_vaegan, "vae": restore_vae,
               "gan": restore_gan, "wgan": restore_gan}
    if family not in ("diffusion", "glow", "glow-eeg", *restore):
        raise ValueError(f"unknown family {family!r}")
    od = cfg.run.out_dir
    out_path = out_path or os.path.join(od, f"{family}_samples.npy")
    if not out_path.endswith(".npy"):
        out_path += ".npy"
    if family in restore:
        trainer = restore[family](cfg, step, device)
        gen = seed_all(seed, trainer.device)
        z = torch.randn((n, cfg.latent_dim), generator=gen,
                        device=trainer.device)
        t0 = time.perf_counter()
        imgs = trainer.generate(z)
    elif family == "glow":
        trainer = restore_glow(cfg, step, device)
        z = trainer.sample_z(seed_all(seed, trainer.device), n)
        t0 = time.perf_counter()
        imgs = trainer.reverse(z) * 2.0
    elif family == "glow-eeg":
        trainer = restore_glow_eeg(cfg, step, device)
        z = trainer.sample_z(seed_all(seed, trainer.device), n)
        t0 = time.perf_counter()
        imgs = trainer.reverse(z)[:, :, 0, :].permute(0, 2, 1)
    else:
        trainer = restore_trainer(cfg, step, device)
        gen = seed_all(seed, trainer.device)
        x_t = torch.randn((n,) + _image_shape(cfg), generator=gen,
                          device=trainer.device)
        t0 = time.perf_counter()
        if ddim_steps > 0:
            imgs = trainer.ddim_sample(x_t, ddim_steps, eta=ddim_eta,
                                       generator=gen)
        else:
            imgs = trainer.ancestral_sample(x_t, cfg.timesteps - 1,
                                            generator=gen)
    imgs = imgs.cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.save(out_path, imgs)
    if family == "glow-eeg" and have_matplotlib():
        plot_eeg_signals(imgs, out_path[:-len(".npy")] + ".png",
                         channel_names=CHANNEL_NAMES)
    print(f"[sample] {family} checkpoint -> {out_path} "
          f"({time.perf_counter() - t0:.3f} s for {n} images)")
    return out_path
