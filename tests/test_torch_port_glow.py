"""Port Glow against the JAX package, on the CPU in f32, at 16x16, batch 4,
2 blocks of 2 flows, coupling width 32, with the fused coupling (K5's plain
versions here, JAX's kernels in interpret mode) and the stock conv chain.

Weights and the Adam state go over the bridge
(``io.jax_params.load_jax_glow_state``); numpy makes every batch, and the
dequantisation noise of each JAX step is rebuilt from its key and handed to
the port.

Lockstep: ``init_step`` and each of 3 JAX train steps are repeated by the
port from the JAX state before it, and the loss, every parameter and every
Adam moment are held to the JAX state after it. At init every ZeroConv is
zero, so the conv1 / conv2 gradients are exactly zero at the first step on
both sides, and tiny at the second; Adam's normalised first updates move
an element by about +-lr whatever the size of its gradient, so an element
whose gradient is within f32 noise can move by up to 2 lr apart (held at
2 lr); every element with a real gradient is held tightly. A free run of 5
steps from the same init is held at the JAX coupling test's rtol 2e-3 /
atol 1e-4 on the losses.

Then ``run_glow`` on the CPU: resume is exact, the CLI trains and serves,
``flow_stack`` raises, and the entry points refuse to run without a card.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.models import glow as JG
from vgd_tpu.ops import image as JI
from vgd_tpu.train.glow import GlowTrainer as JT
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.jax_params import (_adam_leaves, _flatten,
                                         from_jax_glow_params,
                                         load_jax_glow_state)
from vgd_tpu_torch.models import glow as PG
from vgd_tpu_torch.ops import image as PI
from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.glow import GlowTrainer as PT

B, HW, FLOWS, BLOCKS, F, LR, STEPS = 4, 16, 2, 2, 32, 1e-4, 3
# forward, logdet, z, reverse: f32 forwards of the same math through
# 2 x 2 flows, which sum in other orders (and solve the triangular systems
# their own way); held at 1e-5 of the largest |value| (observed <= 6e-7)
FWD_REL = 1e-5
LOSS_RTOL = 1e-5
# one step from the same state: elements with a real gradient (at least
# 1e-2 of their tensor's largest and 1e-5 of the model's), 1e-6; the others
# at 2 lr (module docstring); Adam moments at 1e-3 of their tensor's max
# plus 1e-5 of the model's largest moment
PARAM_ATOL, NOISE_PARAM_ATOL = 1e-6, 2 * LR
REAL_GRAD_TENSOR, REAL_GRAD_NET = 1e-2, 1e-5
MOM_REL, MOM_FLOOR = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _perturbed_params(model, key, noise, seed):
    """JAX init with every trainable leaf but P / s_sign perturbed, so the
    ZeroConvs are non-zero and ActNorm is not the identity."""
    rng = np.random.default_rng(seed)
    params = model.init(key)
    leaves = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [getattr(k, "key", str(k)) for k in path]
        if not {"P", "s_sign"} & set(names):
            leaf = leaf + noise * rng.standard_normal(leaf.shape).astype(
                np.float32)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), leaves)


def _models(fused, flows=FLOWS, noise=0.1, seed=0):
    jm = JG.Glow(in_channels=3, n_flows=flows, n_blocks=BLOCKS,
                 filter_size=F, compute_dtype=jnp.float32,
                 fused_coupling=fused)
    params = _perturbed_params(jm, jax.random.key(seed), noise, seed)
    pm = PG.Glow(in_channels=3, n_flows=flows, n_blocks=BLOCKS,
                 filter_size=F, fused_coupling=fused)
    pm.load_state_dict(from_jax_glow_params(_np(params), pm), strict=True)
    return jm, params, pm


def _close(got, want, err_msg="", rel=FWD_REL, atol=0.0):
    got, want = np.asarray(got.detach()), np.asarray(want)
    assert got.shape == want.shape, err_msg
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + atol, (err_msg, err)


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_model_matches_jax(fused):
    """forward (log_p, logdet, every z), the ActNorm init statistics,
    reverse(reconstruct=True) back to x, and reverse from sampled z."""
    jm, params, pm = _models(fused)
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal((B, HW, HW, 3))).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    lp_j, ld_j, z_j = jm.forward(params, xj)
    with torch.no_grad():
        lp, ld, zs = pm(xt)
    _close(lp, lp_j)
    _close(ld, ld_j)
    assert len(zs) == len(z_j) == BLOCKS
    for a, b in zip(zs, z_j):
        _close(a, b)
    back = pm.reverse(zs, reconstruct=True)
    _close(back, x, rel=0.0, atol=1e-4)
    _close(back, jm.reverse(params, z_j, reconstruct=True))
    z = [0.7 * rng.standard_normal((B,) + s).astype(np.float32)
         for s in PG.calc_z_shapes(3, HW, BLOCKS)]
    _close(pm.reverse([torch.from_numpy(a) for a in z]),
           jm.reverse(params, [jnp.asarray(a) for a in z]))
    new = _np(jm.init_actnorm(params, xj))
    pm.init_actnorm(xt)
    for i in range(BLOCKS):
        an = getattr(pm, f"block{i}").flows.actnorm
        for k in ("b", "s"):
            _close(getattr(an, k), new[f"block{i}"]["flows"]["actnorm"][k],
                   err_msg=f"block{i} {k}")


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_eeg_variant_matches_jax(fused):
    """The EEG variant (time squeeze, (3, 1) convs padded on time only,
    constant channels): forward and reconstruction."""
    jm = JG.Glow(in_channels=4, n_flows=2, n_blocks=2, variant="eeg",
                 filter_size=16, compute_dtype=jnp.float32,
                 fused_coupling=fused)
    pm = PG.Glow(in_channels=4, n_flows=2, n_blocks=2, variant="eeg",
                 filter_size=16, fused_coupling=fused)
    g = torch.Generator().manual_seed(3)
    pm.init_parameters(g)
    with torch.no_grad():
        for t in pm.parameters():
            t.add_(0.1 * torch.randn(t.shape, generator=g))
    # the JAX tree from the port's state_dict (the bridge's inverse)
    params = {}
    for key, t in pm.state_dict().items():
        *path, leaf = key.split(".")
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(t.numpy())
    x = np.random.default_rng(4).standard_normal((2, 16, 1, 4)).astype(
        np.float32)
    lp_j, ld_j, z_j = jm.forward(params, jnp.asarray(x))
    with torch.no_grad():
        lp, ld, zs = pm(torch.from_numpy(x))
    for a, b in zip([lp, ld, *zs], [lp_j, ld_j, *z_j]):
        _close(a, b)
    assert [tuple(z.shape[1:]) for z in zs] == PG.calc_z_shapes_eeg(4, 16, 2)
    _close(pm.reverse(zs, reconstruct=True), x, rel=0.0, atol=1e-4)


def test_reverse_guard_keeps_wild_weights_finite():
    """Strongly perturbed weights overflow f32 through the inverse chain;
    the REV_GUARD clip keeps the samples finite, as in the JAX package."""
    pm = PG.Glow(in_channels=3, n_flows=4, n_blocks=BLOCKS, filter_size=F)
    g = torch.Generator().manual_seed(2)
    pm.init_parameters(g)
    with torch.no_grad():
        for name, t in pm.named_parameters():
            t.add_(0.6 * torch.randn(t.shape, generator=g))
    rng = np.random.default_rng(5)
    z = [torch.from_numpy((0.7 * rng.standard_normal((2,) + s)).astype(
        np.float32)) for s in PG.calc_z_shapes(3, HW, BLOCKS)]
    out = pm.reverse(z)
    assert out.shape == (2, HW, HW, 3) and torch.isfinite(out).all()
    assert float(out.abs().max()) <= pm.REV_GUARD


def test_squeeze_shapes_loss_and_quantisation_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 6, 5)).astype(np.float32)
    for pf, jf in ((PG.squeeze2d, JG.squeeze2d),
                   (PG.unsqueeze2d, JG.unsqueeze2d)):
        arr = x if pf is PG.squeeze2d else x[..., :4]
        np.testing.assert_array_equal(pf(torch.from_numpy(arr)).numpy(),
                                      np.asarray(jf(jnp.asarray(arr))))
    t = rng.standard_normal((2, 8, 1, 6)).astype(np.float32)
    for pf, jf in ((PG.squeeze_time, JG.squeeze_time),
                   (PG.unsqueeze_time, JG.unsqueeze_time)):
        np.testing.assert_array_equal(pf(torch.from_numpy(t)).numpy(),
                                      np.asarray(jf(jnp.asarray(t))))
    back = PG.unsqueeze2d(PG.squeeze2d(torch.from_numpy(x[:, :, :, :])))
    assert torch.equal(back, torch.from_numpy(x))
    assert PG.calc_z_shapes(3, 64, 4) == JG.calc_z_shapes(3, 64, 4)
    assert PG.calc_z_shapes_eeg(22, 160, 4) == JG.calc_z_shapes_eeg(22, 160,
                                                                    4)
    lp = rng.standard_normal(4).astype(np.float32) * 100 - 5000
    got = PG.calc_loss(torch.from_numpy(lp), torch.tensor(1234.5), 64, 32.0)
    want = JG.calc_loss(jnp.asarray(lp), jnp.float32(1234.5), 64, 32.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    u8 = rng.integers(0, 256, (3, 4, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        PI.quantize_bits(PI.to_unit(torch.from_numpy(u8)), 5).numpy(),
        np.asarray(JI.quantize_bits(JI.to_unit(jnp.asarray(u8)), 5)))


def test_init_draws_a_valid_plu_and_zero_couplings():
    """The port's own seeded init: W = P L U is orthogonal (the Q of a QR),
    conv kernels N(0, 0.05), ZeroConvs and priors zero, ActNorm identity."""
    pm = PG.Glow(in_channels=3, n_flows=3, n_blocks=2, filter_size=64)
    pm.init_parameters(torch.Generator().manual_seed(0))
    inv = pm.block0.flows.invconv
    w = PG.Glow._plu_weight(inv)
    eye = torch.eye(w.shape[-1]).expand_as(w)
    torch.testing.assert_close(w @ w.transpose(1, 2), eye, atol=1e-5,
                               rtol=0)
    assert abs(float(pm.block0.flows.coupling.conv2.w.detach().std())
               - 0.05) < 2e-3
    assert not any(t.abs().sum() for t in (
        *pm.block1.flows.coupling.zero.parameters(),
        *pm.block1.prior.parameters()))
    assert torch.equal(pm.block0.flows.actnorm.s, torch.ones(3, 12))
    assert {k for k, _ in pm.named_buffers()} == {
        f"block{i}.flows.invconv.{n}" for i in range(2)
        for n in ("P", "s_sign")}


def _cfgs(**kw):
    common = dict(n_flows=FLOWS, n_blocks=BLOCKS, filter_size=F, lr=LR,
                  fused_coupling=True, **kw)
    jc = JC.GlowConfig(
        data=JC.DataConfig(image_size=(HW, HW), batch_size=B,
                           normalize=False),
        run=JC.RunConfig(compute_dtype="float32"), **common)
    pc = PC.GlowConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=B,
                           normalize=False),
        run=PC.RunConfig(compute_dtype="float32"), **common)
    return jc, pc


def _draws(i):
    """Step i's uint8 batch, its key and the U(0, 1) noise JAX draws."""
    batch = np.random.default_rng(200 + i).integers(0, 256, (B, HW, HW, 3),
                                                     dtype=np.uint8)
    key = jax.random.PRNGKey(200 + i)
    return batch, key, np.array(jax.random.uniform(key, batch.shape))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX states before init_step, after it, and after each of STEPS
    train steps, and each step's metrics."""
    jc, pc = _cfgs()
    jt = JT(jc, (HW, HW, 3))
    st = jt.init(jax.random.PRNGKey(0))
    states = [jax.device_get(st)]
    batch, key, _ = _draws(-1)
    st = jt.init_step(st, jnp.asarray(batch), key)
    states.append(jax.device_get(st))
    metrics = []
    for i in range(STEPS + 2):
        batch, key, _ = _draws(i)
        st, m = jt.train_step(st, jnp.asarray(batch), key)
        states.append(jax.device_get(st))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return pc, states, metrics


def _port_trainer(pc, state):
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    return load_jax_glow_state(tr, state)


def _port_step(tr, i):
    batch, _, noise = _draws(i)
    return tr.train_step(torch.from_numpy(batch),
                         noise=torch.from_numpy(noise))


def _check_state(tr, after, before):
    model = tr.model
    want = from_jax_glow_params(_np(after.params), model)
    for k, buf in model.named_buffers():
        assert torch.equal(buf, want[k]), k
    if before is None:
        for k, p in model.named_parameters():
            _close(p, want[k], err_msg=k)
        return
    _, mu, nu = _adam_leaves(after.opt_state)
    _, mu0, _ = _adam_leaves(before.opt_state)
    mu, nu, mu0 = (_flatten(_np(t)) for t in (mu, nu, mu0))
    grads = {k: (mu[k] - 0.9 * mu0[k]) / 0.1 for k in mu}
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    state = tr.opt.state_dict()["state"]
    for key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
        top = max(float(np.abs(v).max()) for v in ref.values())
        for j, (k, _) in enumerate(model.named_parameters()):
            err = float(np.abs(state[j][key].numpy() - ref[k]).max())
            assert err <= MOM_REL * float(np.abs(ref[k]).max()) + \
                MOM_FLOOR * top, (k, key, err)
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k].numpy())
        g = np.abs(grads[k])
        real = (g >= REAL_GRAD_TENSOR * g.max()) & (g > REAL_GRAD_NET * gmax)
        assert not real.any() or diff[real].max() <= PARAM_ATOL, \
            (k, float(diff[real].max()))
        assert diff.max() <= NOISE_PARAM_ATOL, (k, float(diff.max()))


def test_init_step_matches_jax(jax_run):
    """ActNorm's data-dependent init from the JAX init: every parameter,
    and a fresh Adam."""
    pc, states, _ = jax_run
    tr = _port_trainer(pc, states[0])
    batch, _, noise = _draws(-1)
    K.LAUNCHES.clear()
    tr.init_step(torch.from_numpy(batch), noise=torch.from_numpy(noise))
    assert not tr.opt.state_dict()["state"] and not K.LAUNCHES
    _check_state(tr, states[1], None)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_from_jax_state_matches_jax(jax_run, step):
    """One port train step from JAX's state before step ``step`` (Adam over
    the bridge): the loss, log_p and logdet, every parameter and every Adam
    moment after it (module docstring for the tolerances)."""
    pc, states, metrics = jax_run
    before, after = states[step + 1], states[step + 2]
    tr = _port_trainer(pc, before)
    m = _port_step(tr, step)
    assert set(m) == set(metrics[step])
    for k, v in m.items():
        assert v.ndim == 0 and not v.requires_grad
        np.testing.assert_allclose(float(v), metrics[step][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert tr.step == int(after.step) == step + 1
    assert all(p.grad is None for p in tr.model.parameters())
    _check_state(tr, after, before)


def test_free_running_steps_match_jax_losses(jax_run):
    """init_step and STEPS + 2 steps in a row from the JAX init."""
    pc, states, metrics = jax_run
    tr = _port_trainer(pc, states[0])
    batch, _, noise = _draws(-1)
    tr.init_step(torch.from_numpy(batch), noise=torch.from_numpy(noise))
    got = [float(_port_step(tr, i)["loss"]) for i in range(STEPS + 2)]
    np.testing.assert_allclose(got, [m["loss"] for m in metrics],
                               rtol=2e-3, atol=1e-4)


def test_bridge_is_strict(jax_run):
    pc, states, _ = jax_run
    tr = PT(pc, (HW, HW, 3), device="cpu")
    params = _np(states[1].params)
    names = {k for k, _ in tr.model.named_parameters()}
    assert "block0.flows.invconv.P" not in names
    assert "block0.flows.invconv.s_sign" not in names
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["block1"]["prior"]["scale"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_glow_params(missing, tr.model)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["block0"]["flows"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unused"):
        from_jax_glow_params(extra, tr.model)
    bad = dataclasses.replace(states[2])
    count, mu, nu = _adam_leaves(bad.opt_state)
    mu = _np(mu)
    mu["block0"]["flows"]["invconv"]["P"] = mu["block0"]["flows"][
        "invconv"]["P"] + 1
    with pytest.raises(ValueError, match="buffer"):
        load_jax_glow_state(tr, dataclasses.replace(
            bad, opt_state={"count": count, "mu": mu, "nu": nu}))


def _run_cfg(out_dir, **run):
    return PC.GlowConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=2,
                           dataset_size=12, normalize=False),
        run=PC.RunConfig(out_dir=str(out_dir), compute_dtype="float32",
                         sample_every_iters=2, checkpoint_every_iters=2,
                         **run),
        n_flows=FLOWS, n_blocks=BLOCKS, filter_size=16, fused_coupling=True)


def test_run_glow_resume_is_exact(tmp_path):
    """4 iterations straight equal 2 plus a resumed 2 (the stream of 5
    train batches per pass wraps once): params and buffers, Adam, the
    generator, the log; sample grids and checkpoints on schedule."""
    straight = L.run_glow(_run_cfg(tmp_path / "a"), n_iter=4, device="cpu")
    L.run_glow(_run_cfg(tmp_path / "b"), n_iter=2, device="cpu")
    resumed = L.run_glow(_run_cfg(tmp_path / "b"), n_iter=4, resume=True,
                         device="cpu")
    ta, tb = straight["trainer"], resumed["trainer"]
    assert ta.step == tb.step == 4
    sa, sb = ta.model.state_dict(), tb.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = ta.opt.state_dict()["state"], tb.opt.state_dict()["state"]
    for i in oa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][key], ob[i][key]), (i, key)

    def rows(path):
        return [{k: v for k, v in json.loads(x).items()
                 if k != "images_per_sec"} for x in
                (path / "glow_loss.jsonl").read_text().splitlines()]
    assert rows(tmp_path / "a") == rows(tmp_path / "b")
    assert [r["iter"] for r in rows(tmp_path / "a")] == [2, 4]
    grid = np.load(tmp_path / "a" / "sample" / "000004.npy")
    assert grid.shape == (20, HW, HW, 3) and np.isfinite(grid).all()
    ckpt = torch.load(tmp_path / "a" / "ckpt" / "00000004.pt",
                      weights_only=True)
    assert ckpt["step"] == 4 and ckpt["opt_step"] == 4
    assert "block0.flows.invconv.P" in ckpt["params"]
    np.testing.assert_array_equal(
        np.load(tmp_path / "b" / "sample" / "000004.npy"), grid)


def test_cli_glow_trains_and_serves(tmp_path, capsys):
    common = ["--out-dir", str(tmp_path), "--image-size", str(HW),
              "--compute-dtype", "float32", "--device", "cpu",
              "--n-flows", "2", "--n-blocks", "2", "--filter-size", "16",
              "--batch-size", "2", "--dataset-size", "8"]
    assert cli.main(["glow", "--iters", "2", "--sample-every", "1",
                     "--fused-coupling"] + common) == 0
    assert "iter 2/2" in capsys.readouterr().out
    ckpt = torch.load(tmp_path / "ckpt" / "00000002.pt", weights_only=True)
    assert ckpt["config"]["fused_coupling"] is True
    assert cli.main(["sample", "--family", "glow", "-n", "3"] + common) == 0
    imgs = np.load(tmp_path / "glow_samples.npy")
    assert imgs.shape == (3, HW, HW, 3) and np.isfinite(imgs).all()
    assert cli.main(["eval-glow", "--max-batches", "1"] + common) == 0
    assert "ssim" in capsys.readouterr().out


def test_flow_stack_raises_until_k6_is_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="K6"):
        PC.GlowConfig(flow_stack=True)
    with pytest.raises(NotImplementedError, match="K6"):
        PC.GlowConfig(flow_stack=16)
    with pytest.raises(NotImplementedError, match="K6"):
        PG.Glow(n_flows=1, n_blocks=1, filter_size=4, flow_stack=True)
    with pytest.raises(NotImplementedError, match="K6"):
        cli.main(["glow", "--flow-stack", "--device", "cpu", "--out-dir",
                  str(tmp_path)])


def test_glow_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _run_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT(cfg, (HW, HW, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.run_glow(cfg, n_iter=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.sample_from_dir("glow", cfg, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.evaluate_glow_from_dir(cfg)
