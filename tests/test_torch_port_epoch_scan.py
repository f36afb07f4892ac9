"""The port's epoch scan (``train.loop._stream_epoch_scan``,
``train.common.StepGraph``) on the CPU, against JAX's streaming scan
(``vgd_tpu/train/loop.py``) and against the port's own per-step loop.

On the CPU the scan's loop calls each step itself, so the two paths of a
``run_*`` loop must give the same bits: parameters, BN buffers, Adam state,
generator state and log rows (the rates aside), and a checkpoint written
by one path resumes on the other. The CUDA-graph capture itself runs only
on a card (``chip_smoke.py --only scan``).
"""
from __future__ import annotations

import dataclasses
import inspect
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import vgd_tpu.train.loop as JL
from vgd_tpu_torch.core.config import (DataConfig, DiffusionConfig, GANConfig,
                                       RunConfig, VAEConfig, VAEGANConfig)
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
from vgd_tpu_torch.train import common
from vgd_tpu_torch.train import loop as L

# (batch, image shape, steps per epoch, SCAN_CHUNK_BYTES): 1-step chunks,
# a quarter of the epoch, the byte budget binding, one step, no step
GRID = [(4, (8, 8, 3), 7, 1),
        (4, (8, 8, 3), 7, 10 ** 9),
        (2, (16, 16, 3), 13, 2 * 16 * 16 * 3 * 3),
        (8, (4, 4, 1), 1, 10 ** 9),
        (3, (5, 5, 3), 9, 3 * 5 * 5 * 3 * 2 + 7),
        (2, (6, 6, 3), 0, 10 ** 9)]


@pytest.mark.parametrize("batch,shape,steps,budget", GRID)
def test_chunk_steps_matches_jax(monkeypatch, batch, shape, steps, budget):
    monkeypatch.setattr(L, "SCAN_CHUNK_BYTES", budget)
    monkeypatch.setattr(JL, "SCAN_CHUNK_BYTES", budget)
    assert L._chunk_steps(batch, shape, steps) == \
        JL._chunk_steps(batch, shape, steps)


class _Prof:
    """Records the chunk hooks both scans call."""

    def __init__(self):
        self.calls = []

    def chunk_begin(self, lo, hi):
        self.calls.append(("begin", lo, hi))

    def chunk_end(self, hi, sync=None):
        self.calls.append(("end", hi))


class _ToyGraph:
    """A StepGraph stand-in: each step's metric is its batch's mean."""

    def __init__(self):
        self.sums, self.chunks = {}, []

    def run(self, chunk):
        self.chunks.append(chunk.shape[0])
        for b in chunk:
            self.sums["m"] = self.sums.get("m", 0.0) + float(b.float().mean())

    def read(self):
        out, self.sums = self.sums, {}
        return out


def _batches(n, batch, shape):
    """n batches, batch i filled with i % 256 (chunk means stay exact)."""
    return [np.full((batch,) + shape, i % 256, np.uint8) for i in range(n)]


@pytest.mark.parametrize("batch,shape,steps,budget", GRID)
def test_stream_epoch_scan_matches_jax(monkeypatch, batch, shape, steps,
                                       budget):
    """The same chunks, hooks, sums, count and global step as JAX's
    streaming scan with the matching toy epoch function."""
    monkeypatch.setattr(L, "SCAN_CHUNK_BYTES", budget)
    monkeypatch.setattr(JL, "SCAN_CHUNK_BYTES", budget)
    chunk_steps = L._chunk_steps(batch, shape, steps)
    data = _batches(steps + 2, batch, shape)
    jax_chunks = []

    def epoch_fn(state, chunk, key):
        jax_chunks.append(chunk.shape[0])
        means = chunk.astype(np.float32).mean(axis=(1, 2, 3, 4))
        return state + chunk.shape[0], {"m": means.mean()}
    jprof, pprof = _Prof(), _Prof()
    state, jsums, jcount, jgstep = JL._stream_epoch_scan(
        epoch_fn, 0, iter(data), steps, chunk_steps, jax.random.PRNGKey(0),
        3, jprof, 5, None)
    toy = _ToyGraph()
    # the port stages the same batches from their rows' selections
    staging = L._Staging(np.concatenate(data), batch, LOCAL, "cpu",
                         chunk_steps, L.SCAN_PREFETCH)
    sels = (np.arange(i * batch, (i + 1) * batch) for i in range(len(data)))
    psums, pcount, pgstep = L._stream_epoch_scan(
        toy, staging.chunks(sels, steps), pprof, 5)
    assert (pcount, pgstep) == (jcount, jgstep) == (steps, 5 + steps)
    assert toy.chunks == jax_chunks and int(state) == steps
    assert pprof.calls == jprof.calls
    assert psums.keys() == jsums.keys()
    for k in jsums:
        assert psums[k] == jsums[k]


# ------------------------------------------------------ both paths agree
def _cfg(family, out_dir):
    run = RunConfig(out_dir=str(out_dir), compute_dtype="float32",
                    fused_conv=family != "diffusion", keep_checkpoints=5)
    if family == "vaegan":
        return VAEGANConfig(data=DataConfig(image_size=(64, 64), batch_size=2,
                                            dataset_size=9), run=run,
                            latent_dim=8, ngf=8, ndf=8, kl_warmup_epochs=3)
    if family == "vae":
        return VAEConfig(data=DataConfig(image_size=(64, 64), batch_size=2,
                                         dataset_size=9, noise_max_std=0.5,
                                         occlusion=True), run=run,
                         latent_dim=8, ngf=8, kl_warmup_epochs=3)
    if family in ("gan", "wgan"):
        return GANConfig(data=DataConfig(image_size=(32, 32), batch_size=2,
                                         dataset_size=9), run=run,
                         latent_dim=8, ngf=8, ndf=8, wgan=family == "wgan",
                         critic_iters=2)
    return DiffusionConfig(data=DataConfig(image_size=(16, 16), batch_size=2,
                                           dataset_size=9), run=run,
                           base_ch=8, timesteps=8)


def _run(family, cfg, scan, epochs, resume=False):
    fn = {"vaegan": L.run_vaegan, "vae": L.run_vae, "gan": L.run_gan,
          "wgan": L.run_gan, "diffusion": L.run_diffusion}[family]
    return fn(cfg, epochs=epochs, max_steps_per_epoch=3, resume=resume,
              device="cpu", epoch_scan=scan)


def _state(res, out_dir):
    """Parameters and buffers, every optimizer's state, the step count and
    the generator state of the last checkpoint."""
    tr = res["trainer"]
    params = (tr.state_dict() if hasattr(tr, "state_dict")
              else tr.model.state_dict())
    opts = getattr(tr, "opts", None) or {"adam": tr.opt}
    payload = Checkpointer(os.path.join(out_dir, "ckpt")).load()
    return ({k: v.clone() for k, v in params.items()},
            {n: o.state_dict() for n, o in opts.items()}, tr.step,
            payload["rng_state"])


def _same(a, b):
    (pa, oa, sa, ga), (pb, ob, sb, gb) = a, b
    assert pa.keys() == pb.keys() and sa == sb
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert oa.keys() == ob.keys()
    for n in oa:
        st_a, st_b = oa[n]["state"], ob[n]["state"]
        assert st_a.keys() == st_b.keys()
        for i in st_a:
            for x in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(st_a[i][x], st_b[i][x]), (n, i, x)
    assert torch.equal(ga, gb)


def _rows(log):
    return [{k: v for k, v in r.items()
             if k not in ("images_per_sec", "val_secs")} for r in log]


@pytest.mark.parametrize("family", ["vaegan", "vae", "gan", "wgan",
                                   "diffusion"])
def test_scan_and_per_step_agree_and_resume_across(tmp_path, monkeypatch,
                                                   family):
    """``epoch_scan=True`` and ``False`` give the same bits over 2 epochs
    of 3 steps (chunks of one step: SCAN_CHUNK_BYTES 1), log rows equal
    but for the rates; the first epoch's checkpoint of either path resumed
    by the other ends where both did."""
    monkeypatch.setattr(L, "SCAN_CHUNK_BYTES", 1)
    out = {}
    for scan in (True, False):
        d = tmp_path / f"straight-{scan}"
        res = _run(family, _cfg(family, d), scan, 2)
        out[scan] = (_state(res, d), _rows(res["log"]))
    _same(out[True][0], out[False][0])
    assert out[True][1] == out[False][1] and len(out[True][1]) == 2
    for scan in (True, False):
        # the other path's epoch-1 checkpoint, resumed by this path
        d = tmp_path / f"resumed-{scan}"
        shutil.copytree(tmp_path / f"straight-{not scan}", d)
        os.remove(Checkpointer(str(d / "ckpt"))._path(2))
        res = _run(family, _cfg(family, d), scan, 2, resume=True)
        _same(_state(res, d), out[True][0])
        assert _rows(res["log"]) == out[True][1][1:]


# -------------------------------------------------------------- defaults
def _jax_default(fn):
    src = inspect.getsource(fn)
    (value,) = re.findall(r"if epoch_scan is None:\s+epoch_scan = (\w+)",
                          src)
    return {"True": True, "False": False}[value]


@pytest.mark.parametrize("family,port,jax_fn", [
    ("vaegan", L.run_vaegan, JL.run_vaegan),
    ("vae", L.run_vae, JL.run_vae),
    ("gan", L.run_gan, JL.run_gan),
    ("wgan", L.run_gan, JL.run_gan),
    ("diffusion", L.run_diffusion, JL.run_diffusion)])
def test_defaults_are_jax(family, port, jax_fn):
    """Both loops take ``epoch_scan=None`` and resolve it to the same
    family default."""
    for fn in (port, jax_fn):
        assert inspect.signature(fn).parameters["epoch_scan"].default is None
    assert L.SCAN_DEFAULT[family] is _jax_default(jax_fn)
    assert L._epoch_scan(family, None, LOCAL, torch.device("cpu")) \
        is _jax_default(jax_fn)


def test_host_staged_group_refuses_the_scan_on_a_card(monkeypatch, capsys):
    """On a card a gloo group cannot be captured: an explicit True raises
    naming --no-epoch-scan, the default falls back to the per-step loop
    with one stderr line; the CPU is not affected."""
    monkeypatch.setattr(L, "staged", lambda group: group is not None)
    mesh = Mesh(data=2, data_group=object())
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    with pytest.raises(ValueError, match="--no-epoch-scan"):
        L._epoch_scan("vaegan", True, mesh, cuda)
    capsys.readouterr()
    assert L._epoch_scan("vaegan", None, mesh, cuda) is False
    out = capsys.readouterr()
    assert "training step by step" in out.err
    assert "per step" in out.out
    assert L._epoch_scan("diffusion", False, mesh, cuda) is False
    assert "epoch scan" not in capsys.readouterr().err
    assert L._epoch_scan("vaegan", True, mesh, cpu) is True
    assert L._epoch_scan("gan", None, mesh, cpu) is False


def test_debug_nans_refuses_the_scan_on_a_card(capsys):
    """``--debug-nans``'s anomaly mode reads every backward result on the
    host, which a capture cannot: on a card an explicit True raises naming
    --no-epoch-scan, the default falls back to the per-step loop with one
    stderr line; without it, or on the CPU, the scan runs."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for family in ("vaegan", "diffusion", "vae", "gan"):
        with pytest.raises(ValueError, match="--no-epoch-scan"):
            L._epoch_scan(family, True, LOCAL, cuda, debug_nans=True)
    capsys.readouterr()
    for family in ("vaegan", "diffusion"):
        assert L._epoch_scan(family, None, LOCAL, cuda,
                             debug_nans=True) is False
        out = capsys.readouterr()
        assert "--debug-nans" in out.err and "step by step" in out.err
        assert "per step (the family's default)" in out.out
        assert L._epoch_scan(family, None, LOCAL, cuda) is True
        assert L._epoch_scan(family, None, LOCAL, cpu,
                             debug_nans=True) is True
    assert L._epoch_scan("vae", False, LOCAL, cuda, debug_nans=True) is False
    assert L._epoch_scan("vae", None, LOCAL, cuda, debug_nans=True) is False
    assert "epoch scan" not in capsys.readouterr().err


def test_debug_nans_run_takes_the_scan_on_the_cpu(tmp_path):
    """On the CPU the scan calls each step itself, so ``run_vaegan`` under
    ``debug_nans`` (anomaly mode) trains through it, to the same bits as
    the per-step loop under it."""
    out = {}
    for scan in (True, False):
        d = tmp_path / f"nans-{scan}"
        cfg = _cfg("vaegan", d)
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, debug_nans=True))
        res = L.run_vaegan(cfg, epochs=1, max_steps_per_epoch=2,
                           device="cpu", epoch_scan=scan)
        out[scan] = _state(res, d)
    _same(out[True], out[False])


# ---------------------------------------------------------------- pieces
class _Owner:
    def __init__(self):
        self.device = torch.device("cpu")
        self.step = 0


def test_step_graph_on_the_cpu_sums_and_counts():
    """Each step is the call itself; ``read`` gives the sums since the last
    read and starts again from 0."""
    owner = _Owner()

    def step(b):
        owner.step += 1
        return {"a": b.float().sum(), "b": b.float().mean()}
    g = common.StepGraph(step, owner)
    chunk = torch.arange(12, dtype=torch.uint8).reshape(3, 2, 2)
    g.run(chunk)
    assert owner.step == 3 and g.steps_run == 3
    assert g.read() == {"a": float(chunk.float().sum()),
                        "b": float(chunk.float().mean(dim=(1, 2)).sum())}
    assert g.read() == {"a": 0.0, "b": 0.0}
    g.run(chunk[:1])
    assert owner.step == 4 and g.read()["a"] == float(chunk[0].sum())


def test_capture_counts_move_to_replays(monkeypatch):
    """Launches counted inside ``capturing()`` leave ``LAUNCHES`` and are
    added back once a replay."""
    monkeypatch.setattr(K, "LAUNCHES", type(K.LAUNCHES)(conv_bn_stats=2))
    with K.capturing() as recorded:
        K.LAUNCHES["conv_bn_stats"] += 3
        K.LAUNCHES["attention_fwd"] += 1
    assert dict(recorded) == {"conv_bn_stats": 3, "attention_fwd": 1}
    assert dict(K.LAUNCHES) == {"conv_bn_stats": 2}
    for _ in range(2):
        K.replayed(recorded)
    assert dict(K.LAUNCHES) == {"conv_bn_stats": 8, "attention_fwd": 2}


@pytest.mark.parametrize("capturable", [False, True])
def test_adam_capturable_only_for_cuda_parameters(capturable):
    """The CPU's Adam refuses ``capturable``: asked for or not, CPU
    parameters get the host-counted optimizer."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = common.adam([p], 1e-3, capturable=capturable)
    assert opt.defaults["capturable"] is False


def test_profiler_traces_the_chunks_over_its_window(tmp_path):
    """``chunk_begin`` starts the trace at the first chunk that overlaps
    [start, stop); ``chunk_end`` writes it once the chunks reach stop."""
    run = dataclasses.replace(RunConfig(), profile_dir=str(tmp_path),
                              profile_steps=(2, 5))
    prof = L._Profiler(run, torch.device("cpu"))
    prof.chunk_begin(0, 2)
    assert prof.prof is None
    prof.chunk_end(2)
    prof.chunk_begin(2, 4)
    assert prof.prof is not None
    torch.ones(4).sum()
    prof.chunk_end(4)
    assert prof.prof is not None
    prof.chunk_begin(4, 6)
    prof.chunk_end(6)
    assert prof.prof is None
    assert os.listdir(tmp_path) == ["trace_steps_2_5.json"]
    prof.chunk_begin(6, 8)
    assert prof.prof is None
