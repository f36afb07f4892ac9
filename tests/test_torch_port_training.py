"""Port DDPM training against the JAX package, on the CPU in f32, at
base_ch 8, 32x32 images, batch 2, T=8.

Numpy makes every input and every draw (batches, timesteps, noise) and
both packages get them. The JAX side is the train step composed from the
package's own pieces (``q_sample``, ``UNet.apply`` of the training form,
``mse``, ``jax.value_and_grad``, ``adam``), compiled once per module;
params go over the weight bridge, the Adam state over the Adam bridge.
Then ``run_diffusion`` on the CPU: resume is exact, the CLI trains, and
the training entry points refuse to run without a card unless told."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_unet import jax_params
from vgd_tpu.models import unet as JU
from vgd_tpu.ops import image as JI
from vgd_tpu.train import common as JCOM
from vgd_tpu.train import diffusion as JD
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.artifacts import MetricLog
from vgd_tpu_torch.io.jax_params import (from_jax_adam_state,
                                         from_jax_params, load_jax_adam_state,
                                         load_jax_params)
from vgd_tpu_torch.train import common as PCOM
from vgd_tpu_torch.train import diffusion as PD
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.utils.prefetch import device_prefetch

T, B, HW, LR, STEPS = 8, 2, 32, 2e-4, 3
# Loss and per-sample eval loss: one f32 UNet forward, held at the UNet
# test's atol 2e-4 on outputs; the MSE of O(1) values keeps that scale.
LOSS_TOL = 2e-4
# Gradients: f32 both sides, summed in other orders through ~20 layers of
# convs, norms and attention: rtol 1e-4 of each tensor's max |g| (as
# tests/test_kernels.py holds the attention VJP). Some gradients are zero in
# exact arithmetic and f32 noise on both sides: at base_ch 8 each GroupNorm
# group is one channel, which cancels the conv bias and time projection in
# front of it, and softmax ignores the key bias. Their noise is below
# 1e-6 of the model's largest gradient, which is the absolute floor.
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6
# Parameters after Adam steps. An element whose gradient is real moves by
# the same update on both sides: atol 2e-5 (observed 9.3e-6 after 3 steps).
# An element whose gradient is f32 noise (below 1e-5 of the largest
# gradient at every step) still moves by up to lr per step, since
# m / sqrt(v) is ~ +-1 for any gradient far above eps, and the noise signs
# differ between the packages: up to 2 lr per step apart.
PARAM_ATOL, NOISE_GRAD = 2e-5, 1e-5
NOISE_PARAM_ATOL = 2 * LR * STEPS


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads for this module: the suite runs several test
    processes on one machine, and torch's default of one thread per core
    in each of them slows every other test file down."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port_cfg():
    return PC.DiffusionConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=B),
        run=PC.RunConfig(compute_dtype="float32"), timesteps=T, base_ch=8,
        time_emb_dim=32, lr=LR)


def _draws(step):
    rng = np.random.default_rng(100 + step)
    batch = rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)
    t = rng.integers(0, T, (B,)).astype(np.int32)
    noise = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    return batch, t, noise


@pytest.fixture(scope="module")
def jax_run():
    """Initial params and the JAX trajectory of STEPS train steps: per step
    (loss, grads, params after, opt_state after); plus the per-sample eval
    loss of the initial params on step 0's draws."""
    jm = JU.UNet(out_ch=3, base_ch=8, time_emb_dim=32, attention=True,
                 dtype=jnp.float32)
    params = jax_params(jm, np.zeros((B, HW, HW, 3), np.float32),
                        np.zeros((B,), np.int32), seed=21)
    sched = JD.make_schedule(T)
    tx = JCOM.adam(LR)

    def forward(p, batch, t, noise):
        xt = JD.q_sample(sched, JI.to_signed(batch), t, noise)
        return jm.apply({"params": p}, xt, t)

    @jax.jit
    def step(p, opt_state, batch, t, noise):
        loss, grads = jax.value_and_grad(
            lambda p: JCOM.mse(forward(p, batch, t, noise), noise))(p)
        updates, new_opt = tx.update(grads, opt_state, p)
        return loss, grads, optax.apply_updates(p, updates), new_opt

    traj, p, opt_state = [], params, tx.init(params)
    for i in range(STEPS):
        loss, grads, p, opt_state = step(p, opt_state, *map(jnp.asarray,
                                                            _draws(i)))
        traj.append((float(loss), jax.device_get(grads), jax.device_get(p),
                     jax.device_get(opt_state)))
    batch, t, noise = _draws(0)
    pred = jax.jit(forward)(params, jnp.asarray(batch), jnp.asarray(t),
                            jnp.asarray(noise))
    eval_ref = np.asarray(jnp.mean(jnp.square(pred - noise), axis=(1, 2, 3)))
    return params, traj, eval_ref


def _port_trainer(params, opt_state=None):
    tr = PD.DiffusionTrainer(_port_cfg(), (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    load_jax_params(tr.model, params)
    if opt_state is not None:
        load_jax_adam_state(tr.opt, tr.model, opt_state)
    return tr


def _step_args(step):
    batch, t, noise = _draws(step)
    return (torch.from_numpy(batch), None, torch.from_numpy(t).long(),
            torch.from_numpy(noise))


def _assert_params(model, jax_tree, jax_grads, what):
    """Params against the JAX tree: PARAM_ATOL where some step's JAX
    gradient is real, NOISE_PARAM_ATOL where every step's is noise."""
    want = from_jax_params(jax_tree, model)
    grads = [from_jax_params(g, model) for g in jax_grads]
    gmax = max(float(v.abs().max()) for g in grads for v in g.values())
    for name, p in model.named_parameters():
        real = torch.stack([g[name].abs() for g in grads]).amax(0) > \
            NOISE_GRAD * gmax
        diff = (p.detach() - want[name]).abs()
        assert not real.any() or float(diff[real].max()) <= PARAM_ATOL, \
            (what, name)
        assert float(diff.max()) <= NOISE_PARAM_ATOL, (what, name)


def test_unet_training_grads_match_jax(jax_run):
    """Loss and the gradient of every parameter of the training-form UNet
    (attention through the K2 autograd.Function), global tokens
    included, against jax.value_and_grad of UNet.apply."""
    params, traj, _ = jax_run
    tr = _port_trainer(params)
    batch, _, t, noise = _step_args(0)
    xt, t, noise = tr._inputs(batch, None, t, noise)
    loss = PCOM.mse(tr.model(xt, t), noise)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), traj[0][0],
                               atol=LOSS_TOL, rtol=0)
    want = from_jax_params(traj[0][1], tr.model)
    names = [n for n, _ in tr.model.named_parameters()]
    assert "cross_attn2.global_tokens" in names and len(names) == len(want)
    gmax = max(float(v.abs().max()) for v in want.values())
    for name, p in tr.model.named_parameters():
        ref = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        bound = GRAD_REL * float(np.abs(ref).max()) + GRAD_FLOOR * gmax
        assert err <= bound, (name, err, bound)
    assert float(tr.model.cross_attn2.global_tokens.grad.abs().max()) > 0


def test_lockstep_train_steps_match_jax(jax_run):
    """Three train steps with the same t and noise: each loss, then every
    parameter after the third step."""
    params, traj, _ = jax_run
    tr = _port_trainer(params)
    for i in range(STEPS):
        loss = tr.train_step(*_step_args(i))
        assert loss.ndim == 0 and loss.requires_grad is False
        np.testing.assert_allclose(float(loss), traj[i][0], atol=LOSS_TOL,
                                   rtol=0, err_msg=f"step {i}")
    assert tr.step == STEPS
    _assert_params(tr.model, traj[-1][2], [g for _, g, _, _ in traj],
                   "after 3 steps")
    # the samplers' fused model holds the very same parameters
    for (na, a), (nb, b) in zip(tr.model.named_parameters(),
                                tr.model_fused.named_parameters()):
        assert na == nb and a is b


def test_eval_loss_matches_jax_per_sample(jax_run):
    params, _, eval_ref = jax_run
    tr = _port_trainer(params)
    batch, _, t, noise = _step_args(0)
    out = tr.eval_loss(batch, t=t, noise=noise)
    assert out.shape == (B,)
    np.testing.assert_allclose(out.numpy(), eval_ref, atol=LOSS_TOL, rtol=0)


def test_adam_state_bridge_continues_a_jax_run(jax_run):
    """JAX params and optax state after 2 steps -> port; one more step on
    each side gives the same params (tolerances: see PARAM_ATOL)."""
    _, traj, _ = jax_run
    _, _, p2, opt2 = traj[1]
    tr = _port_trainer(p2, opt2)
    st = tr.opt.state_dict()["state"]
    assert float(st[0]["step"]) == 2.0
    first = next(iter(tr.model.named_parameters()))[0]
    mu = from_jax_params(opt2[0].mu, tr.model)[first]
    torch.testing.assert_close(st[0]["exp_avg"], mu, rtol=0, atol=0)
    tr.train_step(*_step_args(2))
    _assert_params(tr.model, traj[2][2], [traj[2][1]], "bridged step 3")


def test_adam_state_bridge_is_strict(jax_run):
    params, traj, _ = jax_run
    tr = _port_trainer(params)
    opt = traj[0][3]
    mu = dict(opt[0].mu)
    mu.pop("out_conv")
    with pytest.raises(ValueError, match="missing"):
        from_jax_adam_state({"count": 1, "mu": mu, "nu": opt[0].nu},
                            tr.model)
    with pytest.raises(ValueError, match="parameters"):
        load_jax_adam_state(torch.optim.Adam([torch.zeros(1)]), tr.model,
                            opt)


def test_timestep_samplers():
    """The sinusoidal schedule is deterministic and equals JAX's; uniform
    and Beta draws differ in their bits, so range and dtype are held."""
    for epoch in (0, 3, 7):
        want = np.asarray(JD.sample_timestep_sinusoidal(16, 1000, epoch, 10))
        got = PD.sample_timestep_sinusoidal(16, 1000, epoch, 10)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    g = torch.Generator().manual_seed(0)
    u = PD.sample_timestep_uniform(g, 4096, 1000)
    assert u.dtype == torch.int64 and int(u.min()) == 0 and \
        int(u.max()) == 999
    b = PD.sample_timestep_beta(g, 4096, 1000)
    assert b.dtype == torch.int32 and 0 <= int(b.min()) and \
        int(b.max()) <= 999
    # Beta(2, 2) has mean 1/2: the mean timestep sits near 999 / 2
    assert abs(float(b.float().mean()) - 499.5) < 20


def test_common_and_artifacts(tmp_path):
    a = torch.tensor([[1.0, 2.0]])
    assert float(PCOM.mse(a, torch.zeros(1, 2))) == 2.5
    assert float(PCOM.mse(a, torch.zeros(1, 2), "sum")) == 5.0
    opt = PCOM.adam([torch.nn.Parameter(torch.zeros(1))], 1e-3)
    assert opt.defaults["betas"] == (0.9, 0.999) and \
        opt.defaults["eps"] == 1e-8
    log = MetricLog(str(tmp_path), "m")
    log.append(epoch=0, loss=1.5)
    log.append(epoch=1, loss=0.5, extra=2)
    log.save()
    rows = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text()
            .splitlines()]
    assert rows == log.history
    npz = np.load(tmp_path / "m.npz")
    assert list(npz["columns"]) == ["epoch", "extra", "loss"]
    assert np.isnan(npz["values"][0, 1]) and npz["values"][1, 2] == 0.5
    batches = [np.full((2, 3), i, np.uint8) for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert [int(x[0, 0]) for x in out] == list(range(5))


def _run_cfg(out_dir):
    return PC.DiffusionConfig(
        data=PC.DataConfig(image_size=(16, 16), batch_size=2,
                           dataset_size=11),
        run=PC.RunConfig(out_dir=str(out_dir), compute_dtype="float32"),
        timesteps=T, base_ch=8, time_emb_dim=32)


def test_run_diffusion_resume_is_exact(tmp_path):
    """2 epochs straight equal 1 epoch plus a resumed epoch: params, Adam
    state, the loss log. 11 images split 10 train / 1 val, so the val
    batch holds one true row and one padded repeat, which must not count."""
    straight = L.run_diffusion(_run_cfg(tmp_path / "a"), epochs=2,
                               max_steps_per_epoch=3, device="cpu")
    L.run_diffusion(_run_cfg(tmp_path / "b"), epochs=1,
                    max_steps_per_epoch=3, device="cpu")
    resumed = L.run_diffusion(_run_cfg(tmp_path / "b"), epochs=2,
                              max_steps_per_epoch=3, resume=True,
                              device="cpu")
    assert straight["val_rows"] == 1 == resumed["val_rows"]
    ta, tb = straight["trainer"], resumed["trainer"]
    assert ta.step == tb.step == 6
    for (name, a), b in zip(ta.model.state_dict().items(),
                            tb.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = ta.opt.state_dict()["state"], tb.opt.state_dict()["state"]
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)

    def losses(path):
        return [(r["train_loss"], r["val_loss"]) for r in map(
            json.loads, (path / "diffusion_loss.jsonl").read_text()
            .splitlines())]
    assert losses(tmp_path / "a") == losses(tmp_path / "b")
    assert len(losses(tmp_path / "a")) == 2
    assert all(np.isfinite(x) for row in losses(tmp_path / "a") for x in row)
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    payload = Checkpointer(str(tmp_path / "b" / "ckpt")).load()
    assert payload["step"] == 2 and payload["opt_step"] == 6
    assert set(payload) >= {"params", "opt_state", "rng_state", "config"}


def test_cli_diffusion_trains_and_serves(tmp_path, capsys):
    common = ["--out-dir", str(tmp_path), "--image-size", "16",
              "--batch-size", "2", "--dataset-size", "8", "--timesteps", "4",
              "--compute-dtype", "float32", "--device", "cpu"]
    assert cli.main(["diffusion", "--epochs", "1", "--steps-per-epoch", "1",
                     "--lr", "1e-3", "--keep-checkpoints", "2", "--no-attn",
                     "--profile-dir", str(tmp_path / "trace")] + common) == 0
    assert "epoch 1/1" in capsys.readouterr().out
    ckpt = torch.load(tmp_path / "ckpt" / "00000001.pt", weights_only=True)
    assert ckpt["config"]["lr"] == 1e-3 and not ckpt["config"]["attention"]
    assert ckpt["config"]["run"]["keep_checkpoints"] == 2
    assert cli.main(["sample", "--family", "diffusion", "-n", "2",
                     "--ddim-steps", "2", "--no-attn"] + common) == 0


def test_profiler_writes_a_trace(tmp_path):
    cfg = _run_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, profile_dir=str(tmp_path / "trace"), profile_steps=(1, 2)))
    L.run_diffusion(cfg, epochs=1, max_steps_per_epoch=3, device="cpu")
    assert (tmp_path / "trace" / "trace_steps_1_2.json").exists()


def test_training_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.run_diffusion(_run_cfg(tmp_path), epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["diffusion", "--out-dir", str(tmp_path), "--epochs", "1"])
