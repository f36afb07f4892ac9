"""The port's parallel layer (``vgd_tpu_torch/parallel``) against the JAX
package's on the CPU, in f32: the process mesh, K1's path and
``BatchNorm`` with the global batch's statistics, the Glow ActNorm init,
the validation metrics summed over ranks, ring attention, the CLI's mesh
flags, the refusals and the multihost start-up.

The port's ranks are fresh processes that ``parallel.launch.spawn``
starts on a gloo world of localhost (one torch thread each); they run
functions of ``parallel.workers`` on their rows (or tokens) of inputs
that numpy makes here, and the JAX side runs the whole batch in this
process (``sp_self_attention`` on a (1, p) mesh of the virtual CPU
devices). Each spawn holds several checks. Tolerance: 1e-5 of the
reference's largest magnitude for forward values and gradients (f32 on
both sides, summed in other orders).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from vgd_tpu.models import glow as JG
from vgd_tpu.ops import fused_conv as JF
from vgd_tpu.parallel import mesh as JM
from vgd_tpu.parallel.sequence_parallel import sp_self_attention
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.jax_params import from_jax_glow_params
from vgd_tpu_torch.models import glow as PG
from vgd_tpu_torch.parallel import mesh as PM
from vgd_tpu_torch.parallel.launch import spawn
from vgd_tpu_torch.train import loop as L

REL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + 1e-12, (what, err)


def _rows(parts, key):
    """The ranks' row blocks of ``key`` stacked back into the batch."""
    return np.concatenate([p[key].numpy() for p in parts])


# ---------------------------------------------------------------- the mesh
@pytest.mark.parametrize("data,model,n", [(-1, 1, 8), (4, 2, 8), (-1, 2, 8),
                                          (2, 4, 8), (1, 8, 8), (-1, 1, 2),
                                          (1, 2, 2), (-1, 4, 4)])
def test_mesh_layout_matches_jax(data, model, n):
    """The resolved axes, and each rank's (d, m) at the device of JAX's
    mesh that holds the same index."""
    jm = JM.build_mesh(data, model, devices=jax.devices()[:n])
    d, m = PM.resolve(data, model, n)
    assert (d, m) == (jm.shape[JM.DATA_AXIS], jm.shape[JM.MODEL_AXIS])
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    order = {int(i): pos for pos, i in np.ndenumerate(ids)}
    base = min(order)
    for rank in range(n):
        mesh = PM.Mesh(d, m, rank)
        assert (mesh.d, mesh.m) == order[base + rank]


@pytest.mark.parametrize("data,model,n", [(3, 1, 8), (2, 2, 8), (4, 4, 2),
                                          (2, 1, 1)])
def test_mesh_refusals_match_jax(data, model, n):
    """A mesh that does not cover the world raises JAX's words."""
    with pytest.raises(ValueError) as want:
        JM.build_mesh(data, model, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        PM.resolve(data, model, n)
    assert str(got.value) == str(want.value)


def test_rows_match_jax_batch_shards():
    """``Mesh.rows`` is the shard of the global batch that JAX's
    ``shard_batch`` puts on the data-axis device, and ``valid_rows``
    counts the true rows of a padded batch on each rank."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jm = JM.build_mesh(4, 2, devices=jax.devices())
    arr = JM.shard_batch(jm, x)
    for shard in arr.addressable_shards:
        pos = next(p for p, dev in np.ndenumerate(jm.devices)
                   if dev == shard.device)
        mesh = PM.Mesh(4, 2, pos[0] * 2 + pos[1])
        np.testing.assert_array_equal(mesh.rows(x), np.asarray(shard.data))
        np.testing.assert_array_equal(mesh.rows(torch.from_numpy(x)),
                                      np.asarray(shard.data))
    assert [PM.Mesh(4, 1, r).valid_rows(5, 8) for r in range(4)] == \
        [2, 2, 1, 0]
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        PM.Mesh(3, 1, 0).rows(x)


# ------------------------------------------------------ op checks, 2 ranks
CONVS = [(0, 0.01), (1, 0.2)]        # the encoder's and the discriminator's
B, H, CIN, COUT = 4, 16, 6, 12


def _conv_case(padding, slope, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, H, CIN)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 4, CIN, COUT))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(COUT)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(COUT)).astype(np.float32)
    ho = (H + 2 * padding - 4) // 2 + 1
    gy = rng.standard_normal((B, ho, ho, COUT)).astype(np.float32)
    return dict(x=x, w=w, gamma=gamma, beta=beta, gy=gy, padding=padding,
                slope=slope)


def _glow_case():
    jm = JG.Glow(in_channels=3, n_flows=2, n_blocks=2, filter_size=16,
                 compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(0))
    x = (0.3 * np.random.default_rng(5).standard_normal(
        (B, 8, 8, 3))).astype(np.float32)
    pm = PG.Glow(in_channels=3, n_flows=2, n_blocks=2, filter_size=16)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    state = from_jax_glow_params(np_params, pm)
    want = jax.tree_util.tree_map(np.asarray,
                                  jm.init_actnorm(params, jnp.asarray(x)))
    return dict(kw=dict(in_channels=3, n_flows=2, n_blocks=2,
                        filter_size=16), state=state,
                x=torch.from_numpy(x)), want


def _ring_case(p, seed=7):
    rng = np.random.default_rng(seed)
    q, k, v, go = (rng.standard_normal((2, 8 * p, 16)).astype(np.float32)
                   for _ in range(4))
    return dict(q=q, k=k, v=v, go=go)


@pytest.fixture(scope="module")
def two_ranks():
    """op_checks on 2 gloo ranks: both conv cases, BatchNorm, the ActNorm
    init and ring attention with p = 2."""
    convs = [_conv_case(p, s, seed) for seed, (p, s) in enumerate(CONVS)]
    rng = np.random.default_rng(11)
    bn = dict(bn_x=rng.standard_normal((B, 5, 5, 8)).astype(np.float32),
              bn_gamma=(1 + 0.1 * rng.standard_normal(8)).astype(np.float32),
              bn_beta=(0.1 * rng.standard_normal(8)).astype(np.float32),
              bn_gy=rng.standard_normal((B, 5, 5, 8)).astype(np.float32))
    glow, glow_want = _glow_case()
    ring = _ring_case(2)
    metrics = _metric_case()

    def port_conv(c):
        out = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in c.items()}
        out["w"] = torch.from_numpy(c["w"].transpose(3, 2, 0, 1).copy())
        return out
    inp = {"conv": [port_conv(c) for c in convs], "glow": glow,
           "ring": {k: torch.from_numpy(v) for k, v in ring.items()},
           "bn": True, **{k: torch.from_numpy(v) for k, v in bn.items()},
           "metrics": metrics}
    parts = spawn("vgd_tpu_torch.parallel.workers:op_checks", 2, inp)
    return parts, convs, bn, glow_want, ring, metrics


def _metric_case():
    """Three batches of 4 fake / real images in [0, 1], the last padded
    (3 true rows: on 2 ranks, rank 1 holds one of them)."""
    rng = np.random.default_rng(13)
    return [tuple(torch.from_numpy(rng.random((4, 16, 16, 3), np.float32))
                  for _ in range(2)) + (n,) for n in (4, 4, 3)]


def test_metric_accumulator_global_over_ranks(two_ranks):
    """MetricAccumulator on 2 ranks, each with its rows of every batch (a
    rank with none of a padded batch's true rows included), against one
    process on the whole batches: SSIM weighted by the true rows, and FID,
    IS and manifold P/R of the features put back in the global order."""
    from vgd_tpu_torch.eval.metrics import MetricAccumulator
    from vgd_tpu_torch.parallel.workers import toy_features
    parts, *_, metrics = two_ranks
    acc = MetricAccumulator(feature_fn=toy_features)
    for fake, real, n in metrics:
        acc.update(fake, real, n_valid=n)
    want = acc.compute()
    for part in parts:
        got = part["metrics"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=REL,
                                       atol=1e-9, err_msg=k)


def _jax_conv(c):
    def f(x, w, g, b):
        y, mean, var = JF.conv_bn_lrelu(x, w, g, b, padding=c["padding"],
                                        slope=c["slope"], force="xla")
        return jnp.sum(y * c["gy"]), (y, mean, var)
    (_, (y, mean, var)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (c["x"], c["w"], c["gamma"], c["beta"])))
    return y, mean, var, grads


@pytest.mark.parametrize("case", range(len(CONVS)),
                         ids=["encoder", "discriminator"])
def test_k1_path_global_statistics_match_jax(two_ranks, case):
    """conv_bn_lrelu (K1's plain version here) on 2 ranks x B/2 against
    JAX's on B: y, the batch mean and var, the gradients of x, w, gamma
    and beta, and the running stats after one update; the statistics and
    parameter gradients bit-equal on both ranks."""
    parts, convs, *_ = two_ranks
    c = convs[case]
    got = [p["conv"][case] for p in parts]
    y, mean, var, (dx, dw, dg, db) = _jax_conv(c)
    _close(_rows(got, "y"), y, "y")
    _close(_rows(got, "dx"), dx, "dx")
    for key, want in (("mean", mean), ("var", var), ("dgamma", dg),
                      ("dbeta", db), ("running_mean", 0.1 * mean),
                      ("running_var", 0.9 + 0.1 * var)):
        _close(got[0][key], want, key)
        assert torch.equal(got[0][key], got[1][key]), key
    _close(got[0]["dw"].permute(2, 3, 1, 0), dw, "dw")
    assert torch.equal(got[0]["dw"], got[1]["dw"])


def test_batchnorm_global_statistics_match_flax(two_ranks):
    """The port's BatchNorm in train mode on 2 ranks against Flax's
    BatchNorm (momentum 0.9) on the whole batch: output, gradients of x,
    scale and bias, and the running stats, which stay Flax's (biased
    variance); bit-equal statistics on both ranks."""
    parts, _, bn, *_ = two_ranks
    mod = nn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    x = jnp.asarray(bn["bn_x"])
    variables = mod.init(jax.random.key(0), x)
    params = {"scale": jnp.asarray(bn["bn_gamma"]),
              "bias": jnp.asarray(bn["bn_beta"])}

    def f(xx, p):
        y, upd = mod.apply({"params": p,
                            "batch_stats": variables["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * bn["bn_gy"]), (y, upd["batch_stats"])
    (_, (y, stats)), (dx, dp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, params)
    got = [p["bn"] for p in parts]
    _close(_rows(got, "y"), y, "y")
    _close(_rows(got, "dx"), dx, "dx")
    for key, want in (("dgamma", dp["scale"]), ("dbeta", dp["bias"]),
                      ("running_mean", stats["mean"]),
                      ("running_var", stats["var"])):
        _close(got[0][key], want, key)
        assert torch.equal(got[0][key], got[1][key]), key


def test_actnorm_init_takes_global_batch(two_ranks):
    """Glow's data-dependent ActNorm init on 2 ranks against JAX's on the
    whole batch: every flow's b (-mean) and s (1 / unbiased std), the same
    bits on both ranks."""
    parts, _, _, want, *_ = two_ranks
    for i in range(2):
        for k in ("b", "s"):
            key = f"block{i}.flows.actnorm.{k}"
            _close(parts[0]["actnorm"][key],
                   want[f"block{i}"]["flows"]["actnorm"][k], key)
            assert torch.equal(parts[0]["actnorm"][key],
                               parts[1]["actnorm"][key])


def _full_attention(q, k, v):
    s = jnp.einsum("bnd,bmd->bnm", q, k) / np.sqrt(q.shape[-1])
    return jnp.einsum("bnm,bmd->bnd", jax.nn.softmax(s, axis=-1), v)


def _check_ring(parts, case, p):
    mesh = JM.build_mesh(1, p, devices=jax.devices()[:p])
    args = [jnp.asarray(case[n]) for n in "qkv"]

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) * case["go"])
    def ring(q, k, v):
        return sp_self_attention(mesh, q, k, v)
    want, grads = jax.jit(lambda *a: (ring(*a), jax.grad(
        loss(ring), argnums=(0, 1, 2))(*a)))(*args)
    full, full_grads = jax.jit(lambda *a: (_full_attention(*a), jax.grad(
        loss(_full_attention), argnums=(0, 1, 2))(*a)))(*args)
    for r, part in enumerate(parts):
        got = part["ring"]
        for ref, refg in ((want, grads), (full, full_grads)):
            _close(got["out"], ref, f"rank {r} out")
            for name, g in zip(("dq", "dk", "dv"), refg):
                _close(got[name], g, f"rank {r} {name}")
        assert all(torch.equal(got[n], parts[0]["ring"][n])
                   for n in ("out", "dq", "dk", "dv"))


def test_ring_attention_two_ranks_matches_jax(two_ranks):
    """Ring attention over 2 ranks against JAX's sp_self_attention on a
    (1, 2) mesh and against full attention: the output and the gradients
    of q, k and v, the same on every rank."""
    parts, *_, ring, _ = two_ranks
    _check_ring(parts, ring, 2)


def test_ring_attention_four_ranks_matches_jax():
    """The same on 4 ranks (three hops of the ring each way)."""
    ring = _ring_case(4, seed=8)
    parts = spawn("vgd_tpu_torch.parallel.workers:op_checks", 4,
                  {"ring": {k: torch.from_numpy(v) for k, v in ring.items()}})
    _check_ring(parts, ring, 4)


# ------------------------------------------------------- CLI and start-up
def test_cli_mesh_flags_reach_runconfig(monkeypatch):
    """--mesh-data / --mesh-model / --multihost reach RunConfig and
    --remat reaches GlowConfig (JAX's test_cli_mesh_flags_reach_runconfig
    for the port); without them the defaults stand."""
    seen = {}
    for name in ("run_glow", "run_diffusion", "run_vae", "run_glow_eeg"):
        monkeypatch.setattr(L, name,
                            lambda cfg, **kw: seen.update(cfg=cfg))
    cli.main(["glow", "--mesh-data", "4", "--mesh-model", "2", "--remat",
              "--multihost"])
    assert seen["cfg"].run.mesh == PC.MeshConfig(data=4, model=2)
    assert seen["cfg"].run.multihost and seen["cfg"].remat
    cli.main(["glow"])
    assert seen["cfg"].run.mesh == PC.MeshConfig()
    assert not seen["cfg"].run.multihost and not seen["cfg"].remat
    cli.main(["diffusion", "--mesh-model", "2"])
    assert seen["cfg"].run.mesh == PC.MeshConfig(data=-1, model=2)
    cli.main(["vae", "--mesh-data", "2"])
    assert seen["cfg"].run.mesh == PC.MeshConfig(data=2, model=1)
    cli.main(["glow-eeg", "--mesh-data", "2", "--multihost"])
    assert seen["cfg"].run.mesh == PC.MeshConfig(data=2, model=1)
    assert seen["cfg"].run.multihost


def _vae_cfg(tmp_path, **run):
    """A tiny denoising VAE (64x64, batch 4, latent 16, ngf 8)."""
    return PC.VAEConfig(
        data=PC.DataConfig(image_size=(64, 64), batch_size=4,
                           dataset_size=11, noise_max_std=0.5,
                           occlusion=False),
        run=PC.RunConfig(out_dir=str(tmp_path), compute_dtype="float32",
                         **run), latent_dim=16, ngf=8)


def test_refusals(tmp_path, monkeypatch):
    """No model-axis consumer (JAX's words), Glow's model-axis refusals
    (tensor parallelism with a coupling kernel, a pipeline whose stage
    count is not the model axis), a mesh larger than the world (JAX's
    words), and a batch the data axis does not divide: each raises before
    any training."""
    with pytest.raises(ValueError, match="has no effect for this family"):
        L.run_vae(_vae_cfg(tmp_path, mesh=PC.MeshConfig(model=2)),
                  device="cpu")
    glow = PC.GlowConfig(run=PC.RunConfig(out_dir=str(tmp_path),
                                          mesh=PC.MeshConfig(model=2)))
    with monkeypatch.context() as mp:
        mp.setattr(L, "build_mesh", lambda data, model: PM.Mesh(1, 2))
        with pytest.raises(ValueError, match="incompatible with "
                           "--fused-coupling/--flow-stack"):
            L.run_glow(dataclasses.replace(glow, fused_coupling=True),
                       device="cpu")
        with pytest.raises(ValueError, match="--pp-stages 4 needs a mesh "
                           "whose model axis has exactly that many"):
            L.run_glow(dataclasses.replace(glow, pp_stages=4), device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1 does not cover 1 "
                       "devices"):
        L.run_vae(_vae_cfg(tmp_path, mesh=PC.MeshConfig(data=2)),
                  device="cpu")
    monkeypatch.setattr(L, "build_mesh", lambda data, model: PM.Mesh(2, 1))
    cfg = dataclasses.replace(_vae_cfg(tmp_path), data=dataclasses.replace(
        _vae_cfg(tmp_path).data, batch_size=3))
    with pytest.raises(ValueError, match="batch 3 is not divisible by the "
                       "data axis"):
        L.run_vae(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "ckpt")


def test_cli_multihost_two_processes_train_vae(tmp_path, capsys):
    """Two ``python -m vgd_tpu_torch.cli vae --multihost`` processes with
    VGD_COORDINATOR / VGD_NUM_PROCESSES / VGD_PROCESS_ID train one
    data-parallel run (the counterpart of tests/test_multihost.py): both
    exit 0, only process 0 prints the backend and writes the log, and one
    process resumes the checkpoint they left."""
    from vgd_tpu_torch.parallel.launch import free_port
    common = ["--device", "cpu", "--out-dir", str(tmp_path), "--image-size",
              "64", "--batch-size", "4", "--dataset-size", "11",
              "--compute-dtype", "float32", "--epochs", "1"]
    args = [sys.executable, "-m", "vgd_tpu_torch.cli", "vae", "--multihost",
            "--mesh-data", "2", "--steps-per-epoch", "2"] + common
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               VGD_COORDINATOR=f"127.0.0.1:{free_port()}",
               VGD_NUM_PROCESSES="2")
    procs = [subprocess.Popen(args, env=dict(env, VGD_PROCESS_ID=str(i)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "backend gloo world 2" in outs[0]
    assert "backend" not in outs[1]
    rows = [json.loads(line) for line in
            (tmp_path / "vae_loss.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])
    assert cli.main(["vae", "--resume"] + common) == 0
    assert "resumed at epoch 1" in capsys.readouterr().out
