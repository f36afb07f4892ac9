"""Port Inception metrics against the JAX package, on the CPU in f32.

* ``eval/inception.py``: the port's InceptionV3 with JAX's variables
  bridged (``io.jax_params.from_jax_inception_params``; BatchNorm scale,
  bias and running statistics perturbed so every leaf matters), 2 images at
  64x64 and 2 at 256x256: every tap and the logits within 1e-4 of the
  largest |value| of JAX's ``InceptionV3``. JAX's network is compiled once
  for the file: JAX's resize to 299 runs first, outside it, and the
  compiled model's own resize of a 299 input is the identity (checked
  here), so each input goes through exactly JAX's model;
* a state_dict file with pytorch-fid's names and random values (written by
  ``tests/test_inception_parity.py``'s independent torch InceptionV3, with
  ``torch.save``) loads into both packages and gives the same features, the
  fc width taken from the file (1008, and 1000 with a ``module.`` prefix);
* ``frechet_distance``, ``inception_score_from_logits`` and
  ``manifold_precision_recall`` equal to JAX's on random features;
  ``MetricAccumulator`` with a ``feature_fn`` against JAX's on the same
  images and bridged weights (FID within the repo's 5e-3, P/R equal, SSIM
  1e-5, IS 1e-5 under a weights tag, absent under ``random-init``);
* ``--fid`` on ``eval-gan`` returns the surrogate keys; ``load_inception``
  refuses to run without a card unless asked for the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.eval import inception as JI
from vgd_tpu.eval import metrics as JM
from vgd_tpu.io.torch_import import import_inception
from vgd_tpu_torch import cli
from vgd_tpu_torch.eval import inception as PI
from vgd_tpu_torch.eval import metrics as PM
from vgd_tpu_torch.io.jax_params import from_jax_inception_params
from test_inception_parity import TInception3, _randomize_bn

N = 2
# f32 on both sides, summed in other orders through 94 layers: each tap
# within 1e-4 of its largest |value|
TAP_REL = 1e-4
# FID from few samples is a sqrtm of a rank-deficient product: the
# repo's FID tolerance (tests/test_inception_parity.py)
FID_RTOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _perturb_bn(variables, seed=0):
    """BatchNorm scale, bias, mean and var moved off their init values."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if "bn" in path:
                noise = 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                v = {"scale": 1 + noise, "bias": noise, "mean": noise,
                     "var": 1 + np.abs(noise)}.get(k, v)
            out[k] = v
        return out
    return {c: walk(t, ()) for c, t in variables.items()}


@pytest.fixture(scope="module")
def jax_inception():
    """JAX's InceptionV3 (jitted init, BN perturbed), its network compiled
    once for (N, 299, 299, 3) (and once for a single image), and the port's
    module with those variables bridged."""
    model = JI.InceptionV3()
    variables = jax.jit(model.init)(jax.random.key(0),
                                    jnp.zeros((1, 75, 75, 3), jnp.float32))
    variables = _perturb_bn(jax.device_get(variables))
    run = jax.jit(model.apply)
    port = PI.InceptionV3()
    port.load_state_dict(from_jax_inception_params(
        variables["params"], variables["batch_stats"], port), strict=True)

    def jax_taps(v, x_unit):
        x = jax.image.resize(jnp.asarray(x_unit),
                             (x_unit.shape[0], 299, 299, 3), method="bilinear")
        return {k: np.asarray(a) for k, a in run(v, x).items()}
    return variables, jax_taps, port


def _images(seed, size):
    return np.random.default_rng(seed).integers(0, 256, (N, size, size, 3),
                                                dtype=np.uint8)


def _held(got, want):
    assert set(got) == set(want) == set(PI.TAPS)
    for k in PI.TAPS:
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max())
        assert err <= TAP_REL * float(np.abs(w).max()), (k, err)


@pytest.mark.parametrize("size", [64, 256])
def test_taps_match_jax(jax_inception, size):
    variables, jax_taps, port = jax_inception
    x = _images(size, size).astype(np.float32) / 255.0
    _held(port(torch.from_numpy(x)), jax_taps(variables, x))


def test_resize_to_299_is_the_identity_in_jax():
    x = np.random.default_rng(1).uniform(0, 1, (1, 299, 299, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.image.resize(jnp.asarray(x), x.shape, "bilinear")), x)


def test_weights_file_loads_into_both(jax_inception, tmp_path):
    """pytorch-fid names (an independent torch InceptionV3) with random
    values: the port's strict load, its features against that network's own
    and against JAX's import of the same file; the fc width from the file,
    a ``module.`` prefix stripped."""
    variables, jax_taps, _ = jax_inception
    torch.manual_seed(7)
    tm = TInception3()
    _randomize_bn(tm, seed=7)
    tm.eval()
    path = str(tmp_path / "pt_inception.pth")
    torch.save(tm.state_dict(), path)
    fn, tag = PI.load_inception(path, feature="2048", device="cpu")
    assert tag == fn.weights_tag == path
    x = _images(3, 64).astype(np.float32) / 255.0
    got = fn.model(torch.from_numpy(x))
    with torch.no_grad():
        f64, f2048, logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k, ref in (("64", f64), ("2048", f2048), ("logits", logits)):
        err = float((got[k] - ref).abs().max())
        assert err <= TAP_REL * float(ref.abs().max()), (k, err)
    _held(got, jax_taps(import_inception(path, variables), x))
    feats, lg = fn(_images(3, 64))
    assert feats.shape == (N, 2048) and lg.shape == (N, 1008)

    tm1000 = TInception3(num_classes=1000)
    path1000 = str(tmp_path / "tv_inception.pth")
    torch.save({f"module.{k}": v for k, v in tm1000.state_dict().items()},
               path1000)
    model, tag = PI.build_inception(path1000, device="cpu")
    assert tag == path1000 and model.fc.out_features == 1000
    assert torch.equal(model.fc.weight, tm1000.fc.weight.detach())
    assert model(torch.from_numpy(x))["logits"].shape == (N, 1000)


def test_random_init_is_seeded_and_tagged():
    fn_a, tag = PI.load_inception(feature="64", device="cpu")
    fn_b, _ = PI.load_inception(feature="64", device="cpu")
    assert tag == fn_a.weights_tag == "random-init"
    u8 = _images(4, 64)
    fa, la = fn_a(u8)
    fb, lb = fn_b(torch.from_numpy(u8))
    assert torch.equal(fa, fb) and torch.equal(la, lb)
    assert fa.shape == (N, 64) and torch.isfinite(la).all()
    with pytest.raises(ValueError, match="feature"):
        PI.load_inception(feature="logits", device="cpu")


def test_feature_statistics_match_jax():
    rng = np.random.default_rng(5)
    real = rng.standard_normal((40, 16)).astype(np.float32)
    fake = (real[:30] + 0.5 * rng.standard_normal((30, 16))).astype(
        np.float32)
    assert PM.frechet_distance(real, fake) == JM.frechet_distance(real, fake)
    logits = rng.standard_normal((37, 11)) * 3
    assert PM.inception_score_from_logits(logits) == \
        JM.inception_score_from_logits(logits)
    for k in (1, 3, 5):
        assert PM.manifold_precision_recall(real, fake, k) == \
            JM.manifold_precision_recall(real, fake, k)
    got = PM.manifold_precision_recall(real[:3], fake, 3)
    assert all(np.isnan(v) for v in got.values())


@pytest.mark.parametrize("tag", ["random-init", "pt_inception.pth"])
def test_metric_accumulator_matches_jax(jax_inception, tag):
    """Four batches of N image pairs (the last with one true row) through
    both accumulators, each with its package's Inception on the same
    variables."""
    variables, jax_taps, port = jax_inception

    def jax_fn(u8):
        out = jax_taps(variables, np.asarray(u8, np.float32) / 255.0)
        return jnp.asarray(out["64"]), jnp.asarray(out["logits"])
    jax_fn.weights_tag = tag

    def port_fn(u8):
        out = port(u8.float() / 255.0)
        return out["64"], out["logits"]
    port_fn.weights_tag = tag
    acc_p, acc_j = PM.MetricAccumulator(port_fn), JM.MetricAccumulator(jax_fn)
    rng = np.random.default_rng(6)
    for i, n in enumerate((N, N, N, 1)):
        real = _images(10 + i, 64).astype(np.float32) / 255.0
        fake = np.clip(real + 0.2 * rng.standard_normal(real.shape), -0.1,
                       1.1).astype(np.float32)
        acc_p.update(torch.from_numpy(fake), torch.from_numpy(real),
                     n_valid=n)
        acc_j.update(jnp.asarray(fake), jnp.asarray(real), n_valid=n)
    got, want = acc_p.compute(), acc_j.compute()
    sfx = "_surrogate" if tag == "random-init" else ""
    keys = {"ssim", "fid" + sfx, "precision" + sfx, "recall" + sfx,
            "f1" + sfx}
    if not sfx:
        keys |= {"inception_score", "inception_score_std"}
    assert set(got) == set(want) == keys
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-5)
    assert got["fid" + sfx] > 0
    np.testing.assert_allclose(got["fid" + sfx], want["fid" + sfx],
                               rtol=FID_RTOL)
    for k in ("precision", "recall", "f1"):
        assert got[k + sfx] == want[k + sfx], k
    if not sfx:
        for k in ("inception_score", "inception_score_std"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_cli_eval_gan_fid_returns_surrogate_keys(tmp_path, capsys):
    common = ["--out-dir", str(tmp_path), "--image-size", "32",
              "--compute-dtype", "float32", "--device", "cpu",
              "--dataset-size", "40", "--batch-size", "4"]
    assert cli.main(["gan", "--epochs", "1", "--steps-per-epoch", "1"]
                    + common) == 0
    capsys.readouterr()
    assert cli.main(["eval-gan", "--fid"] + common) == 0
    (res,) = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"fid_surrogate", "precision_surrogate", "recall_surrogate",
            "f1_surrogate", "ssim", "step"} == set(res)
    assert np.isfinite(res["fid_surrogate"])


def test_inception_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PI.load_inception()
