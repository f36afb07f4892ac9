"""Port VAE-GAN against the JAX package, on the CPU in f32, at 64x64, batch
4, ngf = ndf = 8, latent 16, with the fused K1 path (its plain version on
the CPU) and the stock path.

Numpy makes every batch; the draws of each JAX ``train_step`` are rebuilt
from its key (``jax.random.split(key, 3)`` -> eps, noise_real, noise_fake)
and handed to the port. Weights, BatchNorm stats and the three Adam states
go over the bridge (``io.jax_params.load_jax_vaegan_state``).

Lockstep: each of 3 JAX train steps is repeated by the port from the JAX
state before it (step 0 from the init, steps 1-2 continue a JAX run through
the Adam-state bridge), and the five losses, every parameter, every BN
stat and every Adam moment are held to the JAX state after it. Run freely
for 3 steps instead, the two packages agree on the losses only to ~3e-4:
Adam's first steps move each element by about +-lr whatever the size of its
gradient, so elements whose gradient is near f32 noise move apart by up to
2 lr, and the GAN carries that into the next steps' losses; the free run is
held at 1e-3 relative.

Then ``run_vaegan`` on the CPU: resume is exact, the CLI trains and serves,
and the entry points refuse to run without a card unless told.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.eval import metrics as JM
from vgd_tpu.models import gan as JG
from vgd_tpu.models import vae as JV
from vgd_tpu.ops import conv as JCONV
from vgd_tpu.train import common as JCOM
from vgd_tpu.train.vaegan import VAEGANTrainer as JT
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.eval import metrics as PM
from vgd_tpu_torch.io import artifacts as PA
from vgd_tpu_torch.io.jax_params import (_adam_leaves, from_jax_params,
                                         load_jax_params,
                                         load_jax_vaegan_state)
from vgd_tpu_torch.models import gan as PG
from vgd_tpu_torch.models import vae as PV
from vgd_tpu_torch.models.blocks import BatchNorm, frozen_running_stats
from vgd_tpu_torch.ops import conv as PCONV
from vgd_tpu_torch.ops import initializers as PI
from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.train import common as PCOM
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.vaegan import VAEGANTrainer as PT

B, HW, LAT, LR, STEPS, RAMP = 4, 64, 16, 2e-4, 3, 0.5
NETS = ("encoder", "decoder", "disc")
# One step from the same state. Losses and BN stats are f32 forwards of the
# same math (observed <= 5e-7 relative). Adam moments carry the step's
# gradient: observed <= 2.5e-6 of the network's largest moment, and every
# parameter whose gradient is real (below) within 1.2e-7, on both paths
# at every step but one. At the stock path's step 2 one element of the
# decoder's last BatchNorm output lies within f32 rounding of 0, so the
# ReLU after it masks it on one side only: that moves one channel's
# gradient by 1.1 %, and through the backward the moments by up to 4.5e-3
# of the network's largest and real parameters by up to 3.3e-5. Held at
# 1e-2 of the network's largest moment (plus 1e-3 of each tensor's own) and
# 1e-4 (half of lr) for real parameters.
LOSS_RTOL, STAT_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
MOM_REL, MOM_FLOOR = 1e-3, 1e-2
# An element is real when its gradient is at least 1e-2 of its tensor's
# largest and 1e-5 of its network's. Below either, Adam's normalised update
# m / sqrt(v) turns the gradient's f32 error into a move of up to lr in
# either direction: held at 2 lr. Among these are the stock path's encoder
# conv biases (a per-channel constant that the BatchNorm after them
# cancels, so their gradient is zero in exact arithmetic and f32 noise on
# both sides; the fused path gives them an exact zero).
PARAM_ATOL, NOISE_PARAM_ATOL = 1e-4, 2 * LR
REAL_GRAD_TENSOR, REAL_GRAD_NET = 1e-2, 1e-5
FREE_LOSS_RTOL = 1e-3
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads for this module, as in the other training
    parity file: the suite runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(fused, **kw):
    common = dict(latent_dim=LAT, ngf=8, ndf=8, lr=LR, **kw)
    jc = JC.VAEGANConfig(
        data=JC.DataConfig(image_size=(HW, HW), batch_size=B),
        run=JC.RunConfig(compute_dtype="float32", fused_conv=fused), **common)
    pc = PC.VAEGANConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=B),
        run=PC.RunConfig(compute_dtype="float32", fused_conv=fused), **common)
    return jc, pc


def _draws(i):
    """Step i's uint8 batch, key, and the draws JAX's step makes from it."""
    batch = np.random.default_rng(100 + i).integers(
        0, 256, (B, HW, HW, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(100 + i)
    k_eps, k_nr, k_nf = jax.random.split(key, 3)
    eps = np.array(jax.random.normal(k_eps, (B, LAT)))
    nr, nf = (np.array(jax.random.normal(k, (B, HW, HW, 3)))
              for k in (k_nr, k_nf))
    return batch, key, eps, nr, nf


@pytest.fixture(scope="module", params=[False, True], ids=["stock", "fused"])
def jax_run(request):
    """The JAX states before and after each of STEPS train steps, and each
    step's metrics."""
    jc, pc = _cfgs(request.param)
    jt = JT(jc, (HW, HW, 3))
    st = jt.init(jax.random.PRNGKey(0), B)
    states, metrics = [jax.device_get(st)], []
    for i in range(STEPS):
        batch, key, _, _, _ = _draws(i)
        st, m = jt.train_step(st, jnp.asarray(batch), key, jnp.float32(RAMP))
        states.append(jax.device_get(st))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return jt, pc, states, metrics


def _port_trainer(pc, state):
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    return load_jax_vaegan_state(tr, state)


def _port_step(tr, i):
    batch, _, eps, nr, nf = _draws(i)
    return tr.train_step(torch.from_numpy(batch), RAMP,
                         eps=torch.from_numpy(eps),
                         noise_real=torch.from_numpy(nr),
                         noise_fake=torch.from_numpy(nf))


def _moments(state, name, net):
    _, mu, nu = _adam_leaves(getattr(state, name).opt_state)
    return from_jax_params(mu, net), from_jax_params(nu, net)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_from_jax_state_matches_jax(jax_run, step):
    """One port train step from JAX's state before step ``step`` (for step
    > 0 the Adam states come over the bridge, continuing a JAX run): the
    five losses, every parameter, BN stat and Adam moment after it."""
    _, pc, states, metrics = jax_run
    before, after = states[step], states[step + 1]
    tr = _port_trainer(pc, before)
    m = _port_step(tr, step)
    assert set(m) == set(metrics[step])
    for k, v in m.items():
        assert v.ndim == 0 and not v.requires_grad
        np.testing.assert_allclose(float(v), metrics[step][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert tr.step == int(after.step) == step + 1
    # D took d_steps Adam steps, E and G one, and nothing keeps a gradient
    counts = {n: float(o.state_dict()["state"][0]["step"])
              for n, o in tr.opts.items()}
    assert counts == {"encoder": step + 1, "decoder": step + 1,
                      "disc": 2 * (step + 1)}
    assert all(p.grad is None for net in tr.nets().values()
               for p in net.parameters())
    for name in NETS:
        net, js = tr.nets()[name], getattr(after, name)
        want = from_jax_params(js.params, net, js.batch_stats)
        for k, buf in net.named_buffers():
            np.testing.assert_allclose(buf.numpy(), want[k].numpy(),
                                       **STAT_TOL, err_msg=f"{name}.{k}")
        mu, nu = _moments(after, name, net)
        mu0, _ = _moments(before, name, net)
        # this step's JAX gradient, from its first moments
        grads = {k: (mu[k] - 0.9 * mu0[k]) / 0.1 for k in mu}
        gmax = max(float(g.abs().max()) for g in grads.values())
        state = tr.opts[name].state_dict()["state"]
        for key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
            top = max(float(v.abs().max()) for v in ref.values())
            for j, (k, _) in enumerate(net.named_parameters()):
                err = float((state[j][key] - ref[k]).abs().max())
                assert err <= MOM_REL * float(ref[k].abs().max()) + \
                    MOM_FLOOR * top, (name, k, key, err)
        for k, p in net.named_parameters():
            diff = (p.detach() - want[k]).abs()
            g = grads[k].abs()
            real = (g >= REAL_GRAD_TENSOR * g.max()) & \
                (g > REAL_GRAD_NET * gmax)
            assert not real.any() or float(diff[real].max()) <= \
                PARAM_ATOL, (name, k, float(diff[real].max()))
            assert float(diff.max()) <= NOISE_PARAM_ATOL, (name, k)


def test_free_running_steps_match_jax_losses(jax_run):
    """Three steps in a row from the JAX init with the same draws: the five
    losses of every step (see the module docstring for the tolerance)."""
    _, pc, states, metrics = jax_run
    tr = _port_trainer(pc, states[0])
    for i in range(STEPS):
        m = _port_step(tr, i)
        for k, v in m.items():
            np.testing.assert_allclose(float(v), metrics[i][k],
                                       rtol=FREE_LOSS_RTOL,
                                       err_msg=f"step {i} {k}")


def test_eval_step_and_generate_match_jax(jax_run):
    """The denoising validation pass and prior sampling after 3 steps, in
    eval mode (running stats), with the JAX draws."""
    jt, pc, states, _ = jax_run
    st = states[-1]
    tr = _port_trainer(pc, st)
    batch, key, _, _, _ = _draws(7)
    want = jax.device_get(jt.eval_step(st, jnp.asarray(batch), key))
    k_n, k_eps = jax.random.split(key)
    noise = np.array(jax.random.normal(k_n, (B, HW, HW, 3)))
    eps = np.array(jax.random.normal(k_eps, (B, LAT)))
    before = K.LAUNCHES["conv_bn_stats"]
    got = tr.eval_step(torch.from_numpy(batch), noise=torch.from_numpy(noise),
                       eps=torch.from_numpy(eps))
    for k in ("val_loss", "per_mse", "per_kl", "recon", "noisy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **FORWARD_TOL, err_msg=k)
    z = np.random.default_rng(8).standard_normal((5, LAT)).astype(np.float32)
    np.testing.assert_allclose(
        tr.generate(torch.from_numpy(z)).numpy(),
        np.asarray(jt.generate(st, jnp.asarray(z))), **FORWARD_TOL)
    assert K.LAUNCHES["conv_bn_stats"] == before
    assert tr.kl_ramp(25) == 0.5 == jt.kl_ramp(25) and tr.kl_ramp(80) == 1.0


def _jax_net(kind, fused):
    if kind == "encoder":
        return JV.Encoder(latent_dim=LAT, dtype=jnp.float32, fused=fused), \
            PV.Encoder(HW, 3, LAT, fused=fused), (B, HW, HW, 3)
    if kind == "generator":
        return JG.Generator(img_size=HW, nz=LAT, ngf=8), \
            PG.Generator(img_size=HW, nz=LAT, ngf=8), (B, 1, 1, LAT)
    return JG.Discriminator(img_size=HW, ndf=8, fused=fused), \
        PG.Discriminator(img_size=HW, ndf=8, fused=fused), (B, HW, HW, 3)


@pytest.mark.parametrize("kind,fused", [("encoder", False), ("encoder", True),
                                        ("generator", False),
                                        ("discriminator", False),
                                        ("discriminator", True)])
def test_networks_match_jax(kind, fused):
    """Each network through the bridge, in train mode (outputs and the
    running stats after two forwards) and in eval mode; the discriminator
    also with its features."""
    jm, pm, shape = _jax_net(kind, fused)
    rng = np.random.default_rng(9)
    x0, x1 = (rng.standard_normal(shape).astype(np.float32) for _ in "ab")
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x0), train=False)
    # move the stats off their init so eval mode reads real values
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * (a == 1), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    load_jax_params(pm, variables["params"], stats)
    kw = {"return_features": True} if kind == "discriminator" else {}
    for x in (x0, x1):
        out, mut = jm.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"], **kw)
        variables = {"params": variables["params"], **mut}
        got = pm(torch.from_numpy(x), train=True, **kw)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(out)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **FORWARD_TOL)
    want = from_jax_params(variables["params"], pm, variables["batch_stats"])
    for k, buf in pm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[k].numpy(), **STAT_TOL,
                                   err_msg=k)
    out = jm.apply(variables, jnp.asarray(x0), train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x0), train=False)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(out)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FORWARD_TOL)


def test_batchnorm_frozen_stats_and_init():
    bn = BatchNorm(5)
    x = torch.randn(3, 4, 4, 5) * 2 + 1
    with frozen_running_stats(torch.nn.Sequential(bn)):
        bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(5))
    bn(x)
    xf = x.reshape(-1, 5)
    torch.testing.assert_close(bn.running_mean, 0.1 * xf.mean(0))
    torch.testing.assert_close(bn.running_var,
                               0.9 + 0.1 * xf.var(0, unbiased=False))
    g = torch.Generator().manual_seed(0)
    w = torch.empty(20000)
    PI.dcgan_conv_init(w, g)
    assert abs(float(w.mean())) < 1e-3 and abs(float(w.std()) - 0.02) < 1e-3
    PI.dcgan_bn_scale_init(w, g)
    assert abs(float(w.mean()) - 1) < 1e-3 and abs(float(w.std()) - 0.02) < 1e-3
    PI.lecun_normal_(w, 50, g)
    assert abs(float(w.std()) - 50 ** -0.5) < 5e-3
    assert float(w.abs().max()) <= 2 * 50 ** -0.5 / 0.8796 + 1e-6


def test_losses_latents_and_conv_transpose_match_jax():
    rng = np.random.default_rng(10)
    p = np.concatenate([rng.uniform(0, 1, 6), [0.0, 1.0]]).astype(np.float32)
    t = rng.uniform(0, 1, 8).astype(np.float32)
    np.testing.assert_allclose(
        float(PCOM.bce(torch.from_numpy(p), torch.from_numpy(t))),
        float(JCOM.bce(jnp.asarray(p), jnp.asarray(t))), rtol=1e-6)
    # a saturated probability (exactly 0 or 1 in f32): the loss is the same
    # and finite, and so is the gradient, which JAX's is not (0 / 0)
    sat = torch.tensor([0.0, 1.0, 0.5], requires_grad=True)
    tgt = torch.tensor([0.9, 0.1, 0.9])
    loss = PCOM.bce(sat, tgt)
    np.testing.assert_allclose(float(loss.detach()), float(JCOM.bce(
        jnp.asarray([0.0, 1.0, 0.5]), jnp.asarray(tgt.numpy()))), rtol=1e-6)
    loss.backward()
    assert torch.isfinite(sat.grad).all()
    assert not np.isfinite(np.asarray(jax.grad(JCOM.bce)(
        jnp.asarray([0.0, 1.0, 0.5]), jnp.asarray(tgt.numpy())))).all()
    mu, lv = (rng.standard_normal((3, 5)).astype(np.float32) * 8 for _ in "ab")
    eps = rng.standard_normal((3, 5)).astype(np.float32)
    z, lvc = PV.reparameterize(torch.from_numpy(mu), torch.from_numpy(lv),
                               torch.from_numpy(eps))
    assert float(lvc.max()) <= 10 and float(lvc.min()) >= -10
    np.testing.assert_allclose(
        z.numpy(), mu + np.exp(0.5 * np.clip(lv, -10, 10)) * eps, rtol=1e-6)
    for mean in (True, False):
        np.testing.assert_allclose(
            float(PV.kl_divergence(torch.from_numpy(mu), lvc, mean)),
            float(JV.kl_divergence(jnp.asarray(mu), jnp.asarray(lvc.numpy()),
                                   mean)), rtol=1e-5)
    assert PV.latent_to_spatial(z).shape == (3, 1, 1, 5)
    # ConvTranspose: in != out, so a wrong transpose of the kernel shows
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    w = rng.standard_normal((4, 4, 3, 7)).astype(np.float32)
    ct = PCONV.ConvTranspose(3, 7, 4, stride=2, padding=1)
    load_jax_params(torch.nn.ModuleDict({"up": ct}), {"up": {"kernel": w}})
    np.testing.assert_allclose(
        ct(torch.from_numpy(x)).detach().numpy(),
        np.asarray(JCONV.conv_transpose2d(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(PG.Generator(img_size=8, nz=4, ngf=2),
                        {"up0": {"kernel": w}})


def test_ssim_and_accumulator_match_jax():
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1, (3, 24, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), -0.1, 1.1).astype(
        np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(PM.ssim(ta, tb)),
                               float(JM.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    assert abs(float(PM.ssim(ta, ta)) - 1.0) < 1e-5
    acc_p, acc_j = PM.MetricAccumulator(), JM.MetricAccumulator()
    for n in (3, 1):     # the second batch has one true row
        acc_p.update(ta, tb, n_valid=n)
        acc_j.update(jnp.asarray(a), jnp.asarray(b), n_valid=n)
    np.testing.assert_allclose(acc_p.compute()["ssim"],
                               acc_j.compute()["ssim"], rtol=1e-5)
    # a feature_fn adds the feature statistics and leaves SSIM as it is
    # (held to JAX's in tests/test_torch_port_fid.py)
    acc_f = PM.MetricAccumulator(feature_fn=lambda u8: (
        u8.float().flatten(1)[:, :8], u8.float().flatten(1)[:, :5]))
    acc_f.update(ta, tb)
    got = acc_f.compute()
    assert set(got) == {"ssim", "fid", "inception_score",
                        "inception_score_std", "precision", "recall", "f1"}
    np.testing.assert_allclose(got["ssim"], float(PM.ssim(ta, tb)),
                               rtol=1e-6)


def test_artifacts(tmp_path):
    imgs = torch.rand(70, 4, 4, 3) * 2 - 1
    grid = np.load(PA.save_grid(imgs, str(tmp_path / "g.npy")))
    assert grid.shape == (64, 4, 4, 3)
    np.testing.assert_array_equal(grid, imgs[:64].numpy())
    tri = np.load(PA.save_triplets(imgs[:2], imgs[2:4], imgs[4:6],
                                   str(tmp_path / "t.npy")))
    assert tri.shape == (3, 2, 4, 4, 3)


def _run_cfg(out_dir, fused=True):
    return PC.VAEGANConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=2,
                           dataset_size=11),
        run=PC.RunConfig(out_dir=str(out_dir), compute_dtype="float32",
                         fused_conv=fused),
        latent_dim=LAT, ngf=8, ndf=8)


def test_run_vaegan_resume_is_exact(tmp_path):
    """2 epochs straight equal 1 epoch plus a resumed epoch: params and BN
    buffers, the three Adam states, the log. 11 images split 10 train / 1
    val, so the val batch holds one true row and one padded repeat."""
    straight = L.run_vaegan(_run_cfg(tmp_path / "a"), epochs=2,
                            max_steps_per_epoch=2, device="cpu")
    L.run_vaegan(_run_cfg(tmp_path / "b"), epochs=1, max_steps_per_epoch=2,
                 device="cpu")
    resumed = L.run_vaegan(_run_cfg(tmp_path / "b"), epochs=2,
                           max_steps_per_epoch=2, resume=True, device="cpu")
    assert straight["val_rows"] == 1 == resumed["val_rows"]
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
        return [json.loads(x) for x in
                (path / "vaegan_loss.jsonl").read_text().splitlines()]
    strip = ("images_per_sec", "val_secs")
    ra = [{k: v for k, v in r.items() if k not in strip}
          for r in rows(tmp_path / "a")]
    rb = [{k: v for k, v in r.items() if k not in strip}
          for r in rows(tmp_path / "b")]
    assert ra == rb and len(ra) == 2
    assert {"train_recon", "train_kl", "train_adv", "train_d_loss",
            "train_g_total", "val_loss", "ssim", "psnr"} <= set(ra[0])
    assert all(np.isfinite(v) for r in ra for v in r.values())
    fake = np.load(tmp_path / "a" / "vaegan_fake_epoch_0002.npy")
    assert fake.shape == (64, HW, HW, 3) and np.abs(fake).max() <= 1
    assert np.load(tmp_path / "a" / "vaegan_decode_epoch_0001.npy").shape \
        == (3, 2, HW, HW, 3)


def test_cli_vaegan_trains_and_serves(tmp_path, capsys):
    common = ["--out-dir", str(tmp_path), "--image-size", str(HW),
              "--compute-dtype", "float32", "--device", "cpu"]
    assert cli.main(["vaegan", "--epochs", "1", "--steps-per-epoch", "1",
                     "--batch-size", "2", "--dataset-size", "6",
                     "--fused-conv", "--profile-dir",
                     str(tmp_path / "trace")] + common) == 0
    assert "epoch 1/1" in capsys.readouterr().out
    ckpt = torch.load(tmp_path / "ckpt" / "00000001.pt", weights_only=True)
    assert ckpt["config"]["run"]["fused_conv"] is True
    assert set(ckpt["opt_state"]) == set(NETS)
    assert cli.main(["sample", "--family", "vaegan", "-n", "3"] + common) == 0
    imgs = np.load(tmp_path / "vaegan_samples.npy")
    assert imgs.shape == (3, HW, HW, 3) and np.abs(imgs).max() <= 1.0


def test_vaegan_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _run_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT(cfg, (HW, HW, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.run_vaegan(cfg, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.sample_from_dir("vaegan", cfg, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["vaegan", "--out-dir", str(tmp_path), "--epochs", "1"])


def test_profiler_window_traces_vaegan_steps(tmp_path):
    cfg = _run_cfg(tmp_path, fused=False)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, profile_dir=str(tmp_path / "trace"), profile_steps=(1, 2)))
    L.run_vaegan(cfg, epochs=1, max_steps_per_epoch=3, device="cpu")
    assert (tmp_path / "trace" / "trace_steps_1_2.json").exists()
