"""Port DCGAN / WGAN against the JAX package, on the CPU in f32, at 32x32,
batch 4, ngf = ndf = 8, latent 16, with the fused K1 discriminator (its
plain version on the CPU) and the stock one.

Numpy makes every batch; the z of each JAX step is rebuilt from its key
(DCGAN: ``split(key, 1)``; WGAN: ``split(key, critic_iters + 1)``, one per
critic step and one for the G step) and handed to the port. Weights,
BatchNorm stats and both Adam states go over the bridge
(``io.jax_params.load_jax_gan_state``).

Lockstep: each of 3 DCGAN steps and 2 WGAN steps is repeated by the port
from the JAX state before it; D and G losses, every parameter, both nets'
BN stats (which pin which forwards advance them: DCGAN's first G forward
advances none, D advances three times; every WGAN G forward advances G's)
and every Adam moment are held to the JAX state after it, at the VAE-GAN
parity file's constants (``tests/test_torch_port_vaegan.py``); after a
WGAN step every D parameter lies in +-clip_value.

Then ``run_gan`` resuming exactly on the CPU, the CLI (``gan`` / ``wgan``
-> ``eval-gan`` -> ``sample``), and the entry points refusing to run
without a card unless told.
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.train.gan import GANTrainer as JT
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.jax_params import (_adam_leaves, from_jax_params,
                                         load_jax_gan_state)
from vgd_tpu_torch.models.blocks import BatchNorm
from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.train import common as PCOM
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.gan import GANTrainer as PT

B, HW, LAT, CH = 4, 32, 16, 8
LR = 2e-4
STEPS = {"dcgan": 3, "wgan": 2}
NETS = ("gen", "disc")
# the constants of tests/test_torch_port_vaegan.py (see its comments)
LOSS_RTOL, STAT_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
MOM_REL, MOM_FLOOR = 1e-3, 1e-2
PARAM_ATOL, NOISE_PARAM_ATOL = 1e-4, 2 * LR
REAL_GRAD_TENSOR, REAL_GRAD_NET = 1e-2, 1e-5
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads, as in the other training parity files: the
    suite runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(fused, wgan=False, out_dir=None, **data):
    kw = dict(image_size=(HW, HW), batch_size=B, **data)
    common = dict(latent_dim=LAT, ngf=CH, ndf=CH, lr=LR, wgan=wgan)
    jc = JC.GANConfig(data=JC.DataConfig(**kw), run=JC.RunConfig(
        compute_dtype="float32", fused_conv=fused), **common)
    run = dict(compute_dtype="float32", fused_conv=fused)
    if out_dir is not None:
        run["out_dir"] = str(out_dir)
    pc = PC.GANConfig(data=PC.DataConfig(**kw), run=PC.RunConfig(**run),
                      **common)
    return jc, pc


def _draws(kind, i, critic_iters=5):
    """Step i's batch, key, and the z JAX's step draws from it."""
    batch = np.random.default_rng(300 + i).integers(0, 256, (B, HW, HW, 3),
                                                    dtype=np.uint8)
    key = jax.random.PRNGKey(300 + i)
    if kind == "dcgan":
        k_z, = jax.random.split(key, 1)
        z = np.array(jax.random.normal(k_z, (B, 1, 1, LAT))).reshape(B, LAT)
    else:
        z = np.stack([np.array(jax.random.normal(k, (B, 1, 1, LAT)))
                      .reshape(B, LAT)
                      for k in jax.random.split(key, critic_iters + 1)])
    return batch, key, torch.from_numpy(z)


def _jax_run(kind, fused):
    """The JAX states before and after each step, and each step's
    metrics."""
    jc, pc = _cfgs(fused, wgan=kind == "wgan")
    jt = JT(jc, (HW, HW, 3))
    st = jt.init(jax.random.PRNGKey(0), B)
    step = jt.train_step_wgan if kind == "wgan" else jt.train_step
    states, metrics = [jax.device_get(st)], []
    for i in range(STEPS[kind]):
        batch, key, _ = _draws(kind, i)
        st, m = step(st, jnp.asarray(batch), key)
        states.append(jax.device_get(st))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return kind, jt, pc, states, metrics


@pytest.fixture(scope="module", params=[False, True], ids=["stock", "fused"])
def dcgan_run(request):
    return _jax_run("dcgan", request.param)


@pytest.fixture(scope="module", params=[False, True], ids=["stock", "fused"])
def wgan_run(request):
    return _jax_run("wgan", request.param)


def _port_trainer(pc, state):
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    return load_jax_gan_state(tr, state)


def _moments(state, name, net):
    _, mu, nu = _adam_leaves(getattr(state, name).opt_state)
    return from_jax_params(mu, net), from_jax_params(nu, net)


def _check_step(run, step):
    """One port step from JAX's state before step ``step``: both losses,
    every parameter, both nets' BN stats and Adam moments after it."""
    kind, _, pc, states, metrics = run
    before, after = states[step], states[step + 1]
    tr = _port_trainer(pc, before)
    batch, _, z = _draws(kind, step)
    launches = K.LAUNCHES["conv_bn_stats"]
    fn = tr.train_step_wgan if kind == "wgan" else tr.train_step
    m = fn(torch.from_numpy(batch), z=z)
    assert K.LAUNCHES["conv_bn_stats"] == launches       # the CPU: no kernel
    assert set(m) == set(metrics[step]) == {"d_loss", "g_loss"}
    for k, v in m.items():
        assert v.ndim == 0 and not v.requires_grad
        np.testing.assert_allclose(float(v), metrics[step][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert tr.step == int(after.step) == step + 1
    # D takes critic_iters Adam steps a WGAN step (one a DCGAN step), G one
    d_steps = pc.critic_iters if kind == "wgan" else 1
    counts = {n: float(o.state_dict()["state"][0]["step"])
              for n, o in tr.opts.items()}
    assert counts == {"gen": step + 1, "disc": d_steps * (step + 1)}
    assert all(p.grad is None for net in tr.nets().values()
               for p in net.parameters())
    if kind == "wgan":
        assert all(float(p.detach().abs().max()) <= pc.clip_value
                   for p in tr.disc.parameters())
    for name in NETS:
        net, js = tr.nets()[name], getattr(after, name)
        want = from_jax_params(js.params, net, js.batch_stats)
        for k, buf in net.named_buffers():
            np.testing.assert_allclose(buf.numpy(), want[k].numpy(),
                                       **STAT_TOL, err_msg=f"{name}.{k}")
        mu, nu = _moments(after, name, net)
        mu0, _ = _moments(before, name, net)
        n_adam = d_steps if name == "disc" else 1
        # the size of each element's gradient: one Adam step's, exactly,
        # from the first moments; over WGAN's critic steps their RMS (up to
        # a factor common to the network), from the second moments
        size = {k: ((mu[k] - pc.beta1 * mu0[k]) / (1 - pc.beta1)).abs()
                if n_adam == 1 else nu[k].sqrt() for k in mu}
        gmax = max(float(g.max()) for g in size.values())
        state = tr.opts[name].state_dict()["state"]
        for key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
            top = max(float(v.abs().max()) for v in ref.values())
            for j, (k, _) in enumerate(net.named_parameters()):
                err = float((state[j][key] - ref[k]).abs().max())
                assert err <= MOM_REL * float(ref[k].abs().max()) + \
                    MOM_FLOOR * top, (name, k, key, err)
        for k, p in net.named_parameters():
            diff = (p.detach() - want[k]).abs()
            g = size[k]
            real = (g >= REAL_GRAD_TENSOR * g.max()) & \
                (g > REAL_GRAD_NET * gmax)
            assert not real.any() or float(diff[real].max()) <= \
                PARAM_ATOL, (name, k, float(diff[real].max()))
            # a noise element moves up to lr either way per Adam step
            assert float(diff.max()) <= n_adam * NOISE_PARAM_ATOL, (name, k)


@pytest.mark.parametrize("step", range(STEPS["dcgan"]))
def test_dcgan_step_from_jax_state_matches_jax(dcgan_run, step):
    _check_step(dcgan_run, step)


@pytest.mark.parametrize("step", range(STEPS["wgan"]))
def test_wgan_step_from_jax_state_matches_jax(wgan_run, step):
    """5 critic steps with clipping, then the G step."""
    _check_step(wgan_run, step)


def test_dcgan_generate_matches_jax(dcgan_run):
    _check_generate(dcgan_run)


def test_wgan_generate_matches_jax(wgan_run):
    _check_generate(wgan_run)


def _check_generate(run):
    """``generate`` in eval mode (running stats) after the run, with z as
    (N, latent) and (N, 1, 1, latent); no K1."""
    _, jt, pc, states, _ = run
    st = states[-1]
    tr = _port_trainer(pc, st)
    z = np.random.default_rng(8).standard_normal((5, LAT)).astype(np.float32)
    want = np.asarray(jt.generate(st, jnp.asarray(z)))
    before = K.LAUNCHES["conv_bn_stats"]
    for zz in (z, z[:, None, None, :]):
        np.testing.assert_allclose(tr.generate(torch.from_numpy(zz)).numpy(),
                                   want, **FORWARD_TOL)
    assert K.LAUNCHES["conv_bn_stats"] == before


def test_clamp_params_clips_parameters_not_running_stats():
    bn = BatchNorm(3)
    net = torch.nn.ModuleDict({"bn": bn, "lin": torch.nn.Linear(4, 3)})
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 1)
        bn.running_mean.fill_(5.0)
        bn.running_var.fill_(7.0)
    PCOM.clamp_params(net, 0.01)
    assert all(float(p.detach().abs().max()) <= 0.01
               for p in net.parameters())
    assert float(bn.weight.detach().abs().max()) == pytest.approx(0.01)
    assert torch.equal(bn.running_mean, torch.full((3,), 5.0))
    assert torch.equal(bn.running_var, torch.full((3,), 7.0))


def test_dcgan_forwards_advance_the_stats_jax_keeps():
    """Independent of JAX: DCGAN's first G forward leaves G's running stats,
    the G step's advances them once; D's advance three times (real, fake,
    the G step's). Counted by wrapping each BatchNorm's update."""
    _, pc = _cfgs(True)
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(1))
    counts = {}
    for name, net in tr.nets().items():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                orig = m.update

                def update(mean, var, orig=orig, m=m, name=name):
                    if m.update_stats:
                        counts[name] = counts.get(name, 0) + 1
                    orig(mean, var)
                m.update = update
    n_bn = {name: sum(isinstance(m, BatchNorm) for m in net.modules())
            for name, net in tr.nets().items()}
    batch, _, z = _draws("dcgan", 0)
    tr.train_step(torch.from_numpy(batch), z=z)
    assert counts == {"gen": n_bn["gen"], "disc": 3 * n_bn["disc"]}
    counts.clear()
    tr.train_step_wgan(torch.from_numpy(batch), z=_draws("wgan", 0)[2])
    assert counts == {"gen": 6 * n_bn["gen"], "disc": 11 * n_bn["disc"]}


# ------------------------------------------------------------ runs and CLI
@pytest.mark.parametrize("wgan", [False, True], ids=["dcgan", "wgan"])
def test_run_gan_resume_is_exact(tmp_path, wgan):
    """2 epochs straight equal 1 epoch plus a resumed epoch: params and BN
    buffers, both Adam states, the log."""
    def cfg(d):
        return _cfgs(True, wgan=wgan, out_dir=tmp_path / d,
                     dataset_size=11)[1]
    straight = L.run_gan(cfg("a"), epochs=2, max_steps_per_epoch=2,
                         device="cpu")
    L.run_gan(cfg("b"), epochs=1, max_steps_per_epoch=2, device="cpu")
    resumed = L.run_gan(cfg("b"), epochs=2, max_steps_per_epoch=2,
                        resume=True, device="cpu")
    ta, tb = straight["trainer"], resumed["trainer"]
    assert ta.step == tb.step == 4
    sa, sb = ta.state_dict(), tb.state_dict()
    assert sa.keys() == sb.keys() and any("running_var" in k for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for name in NETS:
        oa = ta.opts[name].state_dict()["state"]
        ob = tb.opts[name].state_dict()["state"]
        for i in oa:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(oa[i][key], ob[i][key]), (name, i, key)

    def rows(path):
        return [{k: v for k, v in json.loads(x).items()
                 if k != "images_per_sec"}
                for x in (path / "gan_loss.jsonl").read_text().splitlines()]
    ra, rb = rows(tmp_path / "a"), rows(tmp_path / "b")
    assert ra == rb and len(ra) == 2
    assert {"d_loss", "g_loss"} <= set(ra[0])
    assert all(np.isfinite(v) for r in ra for v in r.values())
    fake = np.load(tmp_path / "a" /
                   f"{'wgan' if wgan else 'gan'}_fake_epoch_0002.npy")
    assert fake.shape == (64, HW, HW, 3) and np.abs(fake).max() <= 1


@pytest.mark.parametrize("cmd", ["gan", "wgan"])
def test_cli_gan_trains_evaluates_and_samples(tmp_path, capsys, cmd):
    common = ["--out-dir", str(tmp_path), "--image-size", str(HW),
              "--compute-dtype", "float32", "--device", "cpu",
              "--dataset-size", "11", "--batch-size", "4"]
    assert cli.main([cmd, "--epochs", "2", "--steps-per-epoch", "1",
                     "--fused-conv"] + common) == 0
    assert "epoch 2/2" in capsys.readouterr().out
    ckpt = torch.load(tmp_path / "ckpt" / "00000002.pt", weights_only=True)
    assert ckpt["config"]["run"]["fused_conv"] is True
    assert ckpt["config"]["wgan"] is (cmd == "wgan")
    assert set(ckpt["opt_state"]) == set(NETS)
    args = ["eval-gan", "--max-checkpoints", "1"] + \
        (["--wgan"] if cmd == "wgan" else [])
    assert cli.main(args + common) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["step"] for r in res] == [2] and 0 < res[0]["ssim"] <= 1
    assert (tmp_path / "metrics.npz").exists()
    assert cli.main(["sample", "--family", cmd, "-n", "3"] + common) == 0
    imgs = np.load(tmp_path / f"{cmd}_samples.npy")
    assert imgs.shape == (3, HW, HW, 3) and np.abs(imgs).max() <= 1.0


def test_cli_wgan_defaults_to_the_reference_epochs():
    a = argparse.Namespace(image_size=None, batch_size=None,
                           dataset_size=None, seed=42, out_dir=None,
                           compute_dtype=None, epochs=None, lr=None)
    assert cli._gan_cfg(a, True).epochs == 1500
    assert cli._gan_cfg(a, False).epochs == 150
    assert cli._gan_cfg(a, True).run.out_dir == "runs/wgan"
    a.epochs = 3
    assert cli._gan_cfg(a, True).epochs == 3


def test_gan_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(False, out_dir=tmp_path)
    for call in (lambda: PT(cfg, (HW, HW, 3)),
                 lambda: L.run_gan(cfg, epochs=1),
                 lambda: L.run_gan(dataclasses.replace(cfg, wgan=True),
                                   epochs=1),
                 lambda: L.evaluate_gan_checkpoints(cfg),
                 lambda: L.sample_from_dir("gan", cfg, n=2),
                 lambda: cli.main(["wgan", "--out-dir", str(tmp_path),
                                   "--epochs", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
