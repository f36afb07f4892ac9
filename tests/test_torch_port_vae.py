"""Port denoising VAE against the JAX package, on the CPU in f32, at 64x64
(the smallest size the VALID encoder takes), batch 4, latent 16, ngf 8, with
the fused K1 encoder (its plain version on the CPU) and the stock one.

Numpy makes every batch; the draws of each JAX function are rebuilt from
its key (``train_step``: ``split(key)`` -> noise, eps; ``corrupt``:
``split(key)`` -> rectangle, noise; rectangle -> 5 splits; noise -> std,
normal) and handed to the port. Weights, BatchNorm stats and the joint Adam
state go over the bridge (``io.jax_params.load_jax_vae_state``).

Lockstep: each of 3 JAX train steps is repeated by the port from the JAX
state before it, and the three losses, every parameter, BN stat and Adam
moment are held to the JAX state after it, at the VAE-GAN parity file's
constants (``tests/test_torch_port_vaegan.py``; the noise bound is 2 lr
of this trainer's lr).

Then the evaluation functions with the same draws, the numpy sampler,
``run_vae`` resuming exactly on the CPU, the CLI (train, occlusion test,
checkpoint sweep, sample, ``denoise`` of a JPEG written here with PIL), and
the entry points refusing to run without a card unless told.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.data.corrupt import (add_gaussian_noise as j_noise,
                                  add_occlusion_rectangle as j_rect,
                                  corrupt as j_corrupt)
from vgd_tpu.data.celeba import make_image_datasets as jdata
from vgd_tpu.eval import sampling as JS
from vgd_tpu.eval import vae_analysis as JA
from vgd_tpu.train.vae import VAETrainer as JT
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.data import corrupt as PCOR
from vgd_tpu_torch.data.celeba import make_image_datasets as pdata
from vgd_tpu_torch.eval import sampling as PS
from vgd_tpu_torch.eval import vae_analysis as PA
from vgd_tpu_torch.io.jax_params import (_adam_leaves, from_jax_params,
                                         load_jax_vae_state)
from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.vae import VAETrainer as PT

B, HW, LAT, NGF, STEPS, RAMP, STD = 4, 64, 16, 8, 3, 0.5, 0.5
LR = 1e-3
# the constants of tests/test_torch_port_vaegan.py (see its comments); the
# noise bound is 2 lr of this trainer
LOSS_RTOL, STAT_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
MOM_REL, MOM_FLOOR = 1e-3, 1e-2
PARAM_ATOL, NOISE_PARAM_ATOL = 1e-4, 2 * LR
REAL_GRAD_TENSOR, REAL_GRAD_NET = 1e-2, 1e-5
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)
# corruption: the same f32 arithmetic on the same draws
CORRUPT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads, as in the other training parity files: the
    suite runs several test processes on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(fused, occlusion=False, out_dir=None, **data):
    kw = dict(image_size=(HW, HW), batch_size=B, noise_max_std=STD,
              occlusion=occlusion, **data)
    common = dict(latent_dim=LAT, ngf=NGF)
    jc = JC.VAEConfig(data=JC.DataConfig(**kw), run=JC.RunConfig(
        compute_dtype="float32", fused_conv=fused), **common)
    run = dict(compute_dtype="float32", fused_conv=fused)
    if out_dir is not None:
        run["out_dir"] = str(out_dir)
    pc = PC.VAEConfig(data=PC.DataConfig(**kw), run=PC.RunConfig(**run),
                      **common)
    return jc, pc


def _batch(i, n=B):
    return np.random.default_rng(100 + i).integers(0, 256, (n, HW, HW, 3),
                                                   dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _noise_draws(key, shape):
    """The draws JAX's ``add_gaussian_noise(key, img, ...)`` makes: (std_u,
    noise)."""
    b = shape[0]
    k_std, k_n = jax.random.split(key)
    return (_t(jax.random.uniform(k_std, (b, 1, 1, 1))).reshape(b),
            _t(jax.random.normal(k_n, shape)))


def _corrupt_draws(key, shape):
    """The draws JAX's ``corrupt(key, img, ...)`` makes, as port draws."""
    b, h, w, _ = shape
    k_rect, k_noise = jax.random.split(key)
    lo, hi = PCOR.rect_side_range(h, w)
    k_h, k_w, k_x, k_y, k_fill = jax.random.split(k_rect, 5)
    std_u, noise = _noise_draws(k_noise, shape)
    return PCOR.CorruptDraws(
        std_u=std_u, noise=noise,
        rect_h=_t(jax.random.randint(k_h, (b,), lo, hi + 1)),
        rect_w=_t(jax.random.randint(k_w, (b,), lo, hi + 1)),
        u_x=_t(jax.random.uniform(k_x, (b,))),
        u_y=_t(jax.random.uniform(k_y, (b,))),
        fill=_t(jax.random.uniform(k_fill, shape)))


def _step_draws(i, occlusion=False):
    """Step i's batch, key, and the draws JAX's train step makes."""
    key = jax.random.PRNGKey(200 + i)
    k_noise, k_eps = jax.random.split(key)
    shape = (B, HW, HW, 3)
    noise = _corrupt_draws(k_noise, shape) if occlusion else \
        _t(jax.random.normal(k_noise, shape))
    return _batch(i), key, noise, _t(jax.random.normal(k_eps, (B, LAT)))


# --------------------------------------------------------------- corruption
@pytest.mark.parametrize("occlusion", [True, False], ids=["rect", "noise"])
@pytest.mark.parametrize("seed,shape", [(0, (5, 64, 64, 3)),
                                        (1, (3, 31, 17, 2)),
                                        (2, (8, 9, 12, 3))])
def test_corrupt_matches_jax(seed, shape, occlusion):
    """``corrupt`` (with occlusion) or ``add_gaussian_noise`` (without) on
    the draws rebuilt from JAX's key splits: within 1e-6 of JAX's, and each
    rectangle exactly JAX's (the pixels JAX filled are the port's filled
    pixels)."""
    img = np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    if not occlusion:
        want = np.asarray(j_noise(key, jnp.asarray(img), 0.3))
        std_u, noise = _noise_draws(key, shape)
        got = PCOR.add_gaussian_noise(torch.from_numpy(img), 0.3, std_u,
                                      noise).numpy()
        np.testing.assert_allclose(got, want, atol=CORRUPT_ATOL, rtol=0)
        return
    want = np.asarray(j_corrupt(key, jnp.asarray(img), 0.3))
    draws = _corrupt_draws(key, shape)
    got = PCOR.corrupt(torch.from_numpy(img), 0.3, draws).numpy()
    np.testing.assert_allclose(got, want, atol=CORRUPT_ATOL, rtol=0)
    k_rect, _ = jax.random.split(key)
    jrect = np.asarray(j_rect(k_rect, jnp.full(shape, 5.0)))
    prect = PCOR.add_occlusion_rectangle(
        torch.full(shape, 5.0), draws.rect_h, draws.rect_w, draws.u_x,
        draws.u_y, draws.fill).numpy()
    np.testing.assert_array_equal(prect != 5.0, jrect != 5.0)
    np.testing.assert_array_equal(prect, jrect)


def test_corrupt_draws_are_in_range_and_seeded():
    g = torch.Generator().manual_seed(3)
    d = PCOR.corrupt_draws((6, 40, 40, 3), g, "cpu")
    lo, hi = PCOR.rect_side_range(40, 40)
    assert (lo, hi) == (1, 10)
    assert int(d.rect_h.min()) >= lo and int(d.rect_w.max()) <= hi
    for u in (d.u_x, d.u_y, d.fill, d.std_u):
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    again = PCOR.corrupt_draws((6, 40, 40, 3),
                               torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    img = torch.zeros(6, 40, 40, 3)
    out = PCOR.corrupt(img, 0.5, d)
    assert float(out.abs().max()) <= 1.0


# ------------------------------------------------------------ lockstep train
@pytest.fixture(scope="module", params=[False, True], ids=["stock", "fused"])
def jax_run(request):
    """The JAX states before and after each of STEPS train steps, and each
    step's metrics."""
    jc, pc = _cfgs(request.param)
    jt = JT(jc, (HW, HW, 3))
    st = jt.init(jax.random.PRNGKey(0), B)
    states, metrics = [jax.device_get(st)], []
    for i in range(STEPS):
        batch, key, _, _ = _step_draws(i)
        st, m = jt.train_step(st, jnp.asarray(batch), key, jnp.float32(RAMP))
        states.append(jax.device_get(st))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return jt, pc, states, metrics


def _port_trainer(pc, state):
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    return load_jax_vae_state(tr, state)


def _moments(state, net_key, net):
    _, mu, nu = _adam_leaves(state.decoder.opt_state)
    return from_jax_params(mu[net_key], net), from_jax_params(nu[net_key],
                                                              net)


def _check_state(tr, before, after):
    """Every BN stat, Adam moment and parameter of the port against the
    JAX state ``after`` (bounds: the module docstring)."""
    assert float(tr.opt.state_dict()["state"][0]["step"]) == \
        float(_adam_leaves(after.decoder.opt_state)[0])
    assert all(p.grad is None for p in tr.parameters())
    state = tr.opt.state_dict()["state"]
    j = 0
    for (key, name) in (("enc", "encoder"), ("dec", "decoder")):
        net, js = tr.nets()[name], getattr(after, name)
        want = from_jax_params(js.params, net, js.batch_stats)
        for k, buf in net.named_buffers():
            np.testing.assert_allclose(buf.numpy(), want[k].numpy(),
                                       **STAT_TOL, err_msg=f"{name}.{k}")
        mu, nu = _moments(after, key, net)
        mu0, _ = _moments(before, key, net)
        grads = {k: (mu[k] - 0.9 * mu0[k]) / 0.1 for k in mu}
        gmax = max(float(g.abs().max()) for g in grads.values())
        for m_key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
            top = max(float(v.abs().max()) for v in ref.values())
            for i, (k, _) in enumerate(net.named_parameters()):
                err = float((state[j + i][m_key] - ref[k]).abs().max())
                assert err <= MOM_REL * float(ref[k].abs().max()) + \
                    MOM_FLOOR * top, (name, k, m_key, err)
        j += len(list(net.parameters()))
        for k, p in net.named_parameters():
            diff = (p.detach() - want[k]).abs()
            g = grads[k].abs()
            real = (g >= REAL_GRAD_TENSOR * g.max()) & \
                (g > REAL_GRAD_NET * gmax)
            assert not real.any() or float(diff[real].max()) <= \
                PARAM_ATOL, (name, k, float(diff[real].max()))
            assert float(diff.max()) <= NOISE_PARAM_ATOL, (name, k)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_from_jax_state_matches_jax(jax_run, step):
    """One port train step from JAX's state before step ``step``: the three
    losses, every parameter, BN stat and Adam moment after it."""
    _, pc, states, metrics = jax_run
    before, after = states[step], states[step + 1]
    tr = _port_trainer(pc, before)
    batch, _, noise, eps = _step_draws(step)
    launches = K.LAUNCHES["conv_bn_stats"]
    m = tr.train_step(torch.from_numpy(batch), RAMP, noise=noise, eps=eps)
    assert K.LAUNCHES["conv_bn_stats"] == launches       # the CPU: no kernel
    assert set(m) == set(metrics[step]) == {"total", "recon", "kl"}
    for k, v in m.items():
        assert v.ndim == 0 and not v.requires_grad
        np.testing.assert_allclose(float(v), metrics[step][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert tr.step == int(after.step) == step + 1
    _check_state(tr, before, after)


def test_occlusion_step_matches_jax():
    """A train step with ``cfg.data.occlusion`` (rectangle + per-sample
    noise from ``corrupt``), fused encoder, from the JAX init."""
    jc, pc = _cfgs(True, occlusion=True)
    jt = JT(jc, (HW, HW, 3))
    st = jax.device_get(jt.init(jax.random.PRNGKey(1), B))
    batch, key, noise, eps = _step_draws(5, occlusion=True)
    after, m = jt.train_step(st, jnp.asarray(batch), key, jnp.float32(RAMP))
    after = jax.device_get(after)
    tr = _port_trainer(pc, st)
    got = tr.train_step(torch.from_numpy(batch), RAMP, noise=noise, eps=eps)
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(m[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    _check_state(tr, st, after)


def test_bridge_refuses_a_tree_it_does_not_know(jax_run):
    _, pc, states, _ = jax_run
    st = states[0]
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    count, mu, nu = _adam_leaves(st.decoder.opt_state)
    bad = st.replace(decoder=st.decoder.replace(opt_state={
        "count": count, "mu": {"enc": mu["enc"]}, "nu": nu}))
    with pytest.raises(ValueError, match="enc"):
        load_jax_vae_state(tr, bad)


# --------------------------------------------------------------- evaluation
def test_eval_denoise_generate_match_jax(jax_run):
    """``eval_step`` (random per-batch std), ``denoise`` and ``generate``
    after 3 steps, in eval mode, with the JAX draws; no K1 in any."""
    jt, pc, states, _ = jax_run
    st = states[-1]
    tr = _port_trainer(pc, st)
    batch, key = _batch(7), jax.random.PRNGKey(7)
    want = jax.device_get(jt.eval_step(st, jnp.asarray(batch), key))
    k_s, k_n, k_eps = jax.random.split(key, 3)
    before = K.LAUNCHES["conv_bn_stats"]
    got = tr.eval_step(torch.from_numpy(batch),
                       std_u=_t(jax.random.uniform(k_s, ())),
                       noise=_t(jax.random.normal(k_n, (B, HW, HW, 3))),
                       eps=_t(jax.random.normal(k_eps, (B, LAT))))
    for k in ("val_loss", "per_mse", "per_kl", "recon", "noisy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **FORWARD_TOL, err_msg=k)
    noisy = np.array(want["noisy"])
    np.testing.assert_allclose(
        tr.denoise(torch.from_numpy(noisy), _t(jax.random.normal(
            key, (B, LAT)))).numpy(),
        np.asarray(jt.denoise(st, jnp.asarray(noisy), key)), **FORWARD_TOL)
    z = np.random.default_rng(8).standard_normal((5, LAT)).astype(np.float32)
    np.testing.assert_allclose(
        tr.generate(torch.from_numpy(z)).numpy(),
        np.asarray(jt.generate(st, jnp.asarray(z))), **FORWARD_TOL)
    assert K.LAUNCHES["conv_bn_stats"] == before
    assert tr.kl_ramp(25) == 0.5 and tr.kl_ramp(80) == 1.0


def test_vae_analysis_matches_jax(jax_run):
    """``denoise_test_loss``, ``renoise_cycle`` and ``latent_traversal``
    (both targets; unclamped reparameterisation) with the JAX draws."""
    jt, pc, states, _ = jax_run
    st = states[-1]
    tr = _port_trainer(pc, st)
    clean = np.random.default_rng(9).uniform(-1, 1, (B, HW, HW, 3)).astype(
        np.float32)
    noisy = np.clip(clean + 0.3 * np.random.default_rng(10).standard_normal(
        clean.shape), -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = JA.denoise_test_loss(jt, st, jnp.asarray(noisy),
                                jnp.asarray(clean), key)
    got = PA.denoise_test_loss(tr, torch.from_numpy(noisy),
                               torch.from_numpy(clean),
                               eps=_t(jax.random.normal(key, (B, LAT))))
    for k in ("test_loss", "mse", "psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["recon"].numpy(),
                               np.asarray(want["recon"]), **FORWARD_TOL)

    cycles = JA.renoise_cycle(jt, st, jnp.asarray(noisy), key, cycles=3)
    draws, k = [], key
    for i in range(3):          # each cycle's key comes from the one before
        k_eps, k_noise, k = jax.random.split(jax.random.fold_in(k, i), 3)
        draws.append((_t(jax.random.normal(k_eps, (B, LAT))),
                      _t(jax.random.normal(k_noise, (B, HW, HW, 3)))))
    got = PA.renoise_cycle(tr, torch.from_numpy(noisy), cycles=3,
                           draws=draws)
    assert len(got) == 3
    for g, w in zip(got, cycles):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FORWARD_TOL)

    for target in ("mu", "logvar"):
        frames = JA.latent_traversal(jt, st, jnp.asarray(noisy[:1]), key,
                                     dim=2, delta=4.0, steps=3,
                                     target=target)
        eps = torch.stack([_t(jax.random.normal(jax.random.fold_in(key, i),
                                                (1, LAT)))
                           for i in range(4)])
        got = PA.latent_traversal(tr, torch.from_numpy(noisy[:1]), dim=2,
                                  delta=4.0, steps=3, target=target, eps=eps)
        assert got.shape == (4, HW, HW, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(frames),
                                   **FORWARD_TOL, err_msg=target)


def test_numpy_sampling_is_bit_equal_to_jax():
    """The port's numpy copy: the same arrays from the same inputs and
    ``default_rng`` seed, through an encoder-shaped function over loaders
    (padded last batch: only its true rows count)."""
    rng = np.random.default_rng(12)
    arr = rng.standard_normal((50, 6)) * rng.uniform(0.5, 3, 6)
    for got, want in zip(PS.vals_to_hist(arr, 20), JS.vals_to_hist(arr, 20)):
        np.testing.assert_array_equal(got, want)
    bins, cdf = JS.vals_to_hist(arr, 20)
    np.testing.assert_array_equal(
        PS.sample_distribution(bins, cdf, 7, np.random.default_rng(3)),
        JS.sample_distribution(bins, cdf, 7, np.random.default_rng(3)))
    jc, pc = _cfgs(False, dataset_size=11)
    w = rng.standard_normal((HW * HW * 3, 4)).astype(np.float32) * 1e-3

    def encode(batch):
        flat = np.asarray(batch, np.float32).reshape(len(batch), -1)
        return flat @ w, flat @ w[:, ::-1]
    jt, jv, _ = jdata(jc.data, seed=5)
    pt, pv, _ = pdata(pc.data, seed=5)
    for got, want in zip(PS.encode_dataset(encode, [pt, pv]),
                         JS.encode_dataset(encode, [jt, jv])):
        assert got.shape == (9, 4)     # 2 full train batches + 1 val row
        np.testing.assert_array_equal(got, want)
    ps = PS.aggregated_posterior_sampler(encode, [pt, pv], n_bins=10, seed=4)
    js = JS.aggregated_posterior_sampler(encode, [jt, jv], n_bins=10, seed=4)
    for _ in range(2):
        for got, want in zip(ps(5), js(5)):
            np.testing.assert_array_equal(got, want)
    # tensors from an encoder come back as numpy too
    mu, lv = PS.encode_dataset(lambda b: tuple(map(torch.from_numpy,
                                                   encode(b))), [pv])
    assert isinstance(mu, np.ndarray) and mu.shape == (1, 4)


# ------------------------------------------------------------ runs and CLI
def test_run_vae_resume_is_exact(tmp_path):
    """2 epochs straight equal 1 epoch plus a resumed epoch: params and BN
    buffers, the Adam state, the log. 11 images split 10 train / 1 val, so
    the val batch holds one true row and three padded repeats."""
    def cfg(d):
        return _cfgs(True, out_dir=tmp_path / d, dataset_size=11)[1]
    straight = L.run_vae(cfg("a"), epochs=2, max_steps_per_epoch=2,
                         device="cpu")
    L.run_vae(cfg("b"), epochs=1, max_steps_per_epoch=2, device="cpu")
    resumed = L.run_vae(cfg("b"), epochs=2, max_steps_per_epoch=2,
                        resume=True, device="cpu")
    assert straight["val_rows"] == 1 == resumed["val_rows"]
    ta, tb = straight["trainer"], resumed["trainer"]
    assert ta.step == tb.step == 4
    sa, sb = ta.state_dict(), tb.state_dict()
    assert sa.keys() == sb.keys() and any("running_var" in k for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = ta.opt.state_dict()["state"], tb.opt.state_dict()["state"]
    assert len(oa) == len(ta.parameters())
    for i in oa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][key], ob[i][key]), (i, key)

    def rows(path):
        return [{k: v for k, v in json.loads(x).items()
                 if k != "images_per_sec"}
                for x in (path / "vae_loss.jsonl").read_text().splitlines()]
    ra, rb = rows(tmp_path / "a"), rows(tmp_path / "b")
    assert ra == rb and len(ra) == 2
    assert {"train_loss", "val_loss", "mse", "psnr", "ssim"} <= set(ra[0])
    assert all(np.isfinite(v) for r in ra for v in r.values())
    fake = np.load(tmp_path / "a" / "vae_fake_epoch_0002.npy")
    assert fake.shape == (64, HW, HW, 3) and np.abs(fake).max() <= 1
    assert np.load(tmp_path / "a" / "vae_valimg_epoch_0001.npy").shape \
        == (3, B, HW, HW, 3)


def test_cli_vae_trains_evaluates_samples_and_denoises(tmp_path, capsys):
    from PIL import Image
    common = ["--out-dir", str(tmp_path), "--image-size", str(HW),
              "--compute-dtype", "float32", "--device", "cpu",
              "--dataset-size", "11", "--batch-size", "4"]
    assert cli.main(["vae", "--epochs", "1", "--steps-per-epoch", "1",
                     "--fused-conv", "--occlusion", "--noise-std", "0.3"]
                    + common) == 0
    assert "epoch 1/1" in capsys.readouterr().out
    ckpt = torch.load(tmp_path / "ckpt" / "00000001.pt", weights_only=True)
    assert ckpt["config"]["run"]["fused_conv"] is True
    assert ckpt["config"]["data"]["occlusion"] is True
    assert ckpt["config"]["data"]["noise_max_std"] == 0.3
    assert cli.main(["eval-vae", "--occlusion", "--max-batches", "1"]
                    + common) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"occlusion"}
    assert {"test_loss", "mse", "psnr", "ssim"} == set(res["occlusion"])
    for name in ("triplets", "renoise_cycles"):
        assert np.load(tmp_path / f"occlusion_{name}.npy").shape[0] == 3
    assert np.load(tmp_path / "occlusion_traversal_mu.npy").shape == \
        (4, HW, HW, 3)
    assert cli.main(["eval-vae", "--max-checkpoints", "1", "--max-batches",
                     "1"] + common) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["step"] for r in res["sweep"]] == [1]
    assert (tmp_path / "vae_aggpost_step_000001.npy").exists()
    assert cli.main(["sample", "--family", "vae", "-n", "3"] + common) == 0
    imgs = np.load(tmp_path / "vae_samples.npy")
    assert imgs.shape == (3, HW, HW, 3) and np.abs(imgs).max() <= 1.0
    src = tmp_path / "face.jpg"
    Image.fromarray(_batch(0, 1)[0]).save(src)
    dst = tmp_path / "restored.png"
    assert cli.main(["denoise", "--ckpt", str(tmp_path / "ckpt"), "--input",
                     str(src), "--output", str(dst), "--image-size",
                     str(HW), "--compute-dtype", "float32", "--device",
                     "cpu"]) == 0
    out = np.asarray(Image.open(dst))
    assert out.shape == (HW, HW, 3) and out.dtype == np.uint8
    # a folder: one output per *.jpg, the same restoration as the file's
    Image.fromarray(_batch(1, 1)[0]).save(tmp_path / "other.jpg")
    assert cli.main(["denoise", "--ckpt", str(tmp_path / "ckpt"), "--input",
                     str(tmp_path), "--output", str(tmp_path / "x.png"),
                     "--image-size", str(HW), "--compute-dtype", "float32",
                     "--device", "cpu"]) == 0
    for name in ("face", "other"):
        assert np.asarray(Image.open(tmp_path / f"denoised_{name}.jpg")
                          ).shape == (HW, HW, 3)


def test_denoise_images_shares_one_eps(tmp_path):
    """``denoise_images`` on arrays: uint8 out, one eps for every image, so
    an image restores the same alone and in a batch."""
    _, pc = _cfgs(False, out_dir=tmp_path, dataset_size=9)
    L.run_vae(pc, epochs=1, max_steps_per_epoch=1, device="cpu")
    imgs = _batch(3, 3)
    out = L.denoise_images(pc, str(tmp_path / "ckpt"), imgs, seed=5,
                           device="cpu")
    assert out.shape == imgs.shape and out.dtype == np.uint8
    alone = L.denoise_images(pc, str(tmp_path / "ckpt"), imgs[1:2], seed=5,
                             device="cpu")
    # the same up to a flipped truncation of one level
    assert np.abs(alone[0].astype(int) - out[1]).max() <= 1


def test_vae_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(False, out_dir=tmp_path)
    imgs = _batch(0, 1)
    for call in (lambda: PT(cfg, (HW, HW, 3)),
                 lambda: L.run_vae(cfg, epochs=1),
                 lambda: L.evaluate_vae_checkpoints(cfg),
                 lambda: L.evaluate_vae_occlusion(cfg),
                 lambda: L.sample_from_dir("vae", cfg, n=2),
                 lambda: L.denoise_images(cfg, str(tmp_path), imgs),
                 lambda: cli.main(["vae", "--out-dir", str(tmp_path),
                                   "--epochs", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
