"""Glow ``remat`` in the port (``GlowConfig.remat``: each flow of the
per-flow chain recomputed in the backward by ``torch.utils.checkpoint``)
on the CPU in f32, at 16x16, batch 4, 2 blocks of 2 flows, width 16.

* The loss and every gradient with ``remat`` equal those without, bit for
  bit, on the stock conv chain and on the fused coupling (K5's plain
  versions here), and with ``flow_stack`` the K6 blocks are untouched.
* One train step of the port with ``remat`` from JAX's state after its
  ``init_step`` against JAX's ``remat`` step (``jax.checkpoint`` on the
  flow scan) with the same dequantisation noise: the loss within 1e-5
  relative; the parameters as ``tests/test_torch_port_glow.py`` holds them
  (elements with a real gradient within 1e-6, the others within 2 lr).
* ``run_glow`` with ``remat`` trains and resumes, and its losses equal a
  run without it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.train.glow import GlowTrainer as JT
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.jax_params import (_adam_leaves, _flatten,
                                         from_jax_glow_params,
                                         load_jax_glow_state)
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.glow import GlowTrainer as PT

B, HW, LR = 4, 16, 1e-4
PARAM_ATOL, NOISE_PARAM_ATOL = 1e-6, 2 * LR
REAL_GRAD_TENSOR, REAL_GRAD_NET = 1e-2, 1e-5


def _pc(**kw):
    return PC.GlowConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=B,
                           normalize=False),
        run=PC.RunConfig(compute_dtype="float32"), n_flows=2, n_blocks=2,
        filter_size=16, lr=LR, **kw)


def _batch(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (B, HW, HW, 3), dtype=np.uint8))


def _grads(cfg, perturb=True):
    """Loss and every parameter gradient of one forward / backward after
    the ActNorm init (ZeroConvs perturbed so every gradient is real)."""
    tr = PT(cfg, (HW, HW, 3), device="cpu")
    gen = torch.Generator().manual_seed(0)
    tr.init(gen)
    tr.init_step(_batch(1), gen)
    if perturb:
        with torch.no_grad():
            for name, p in tr.model.named_parameters():
                if "zero" in name or "prior" in name:
                    p.add_(0.01 * torch.randn(p.shape, generator=gen))
    x = tr._prep(_batch(2), gen, None)
    log_p, logdet, _ = tr.model(x)
    loss, _, _ = tr._loss(log_p, logdet)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in tr.model.named_parameters()}


@pytest.mark.parametrize("kw", [{}, {"fused_coupling": True},
                                {"fused_coupling": True, "flow_stack": 16}],
                         ids=["stock", "fused", "flow-stack"])
def test_remat_gradients_equal_no_remat(kw):
    """remat changes when the flows' activations are made, not what is
    computed: the loss and every gradient are bit-equal."""
    loss0, g0 = _grads(_pc(**kw))
    loss1, g1 = _grads(_pc(remat=True, **kw))
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_recomputes_each_flow():
    """Under remat the backward runs every flow's forward again: the
    coupling network runs twice per flow per step (counted on the stock
    path's first conv)."""
    calls = []
    tr = PT(_pc(remat=True), (HW, HW, 3), device="cpu")
    gen = torch.Generator().manual_seed(0)
    tr.init(gen)
    tr.init_step(_batch(1), gen)
    orig = tr.model._coupling_nn

    def counted(p, xa):
        calls.append(1)
        return orig(p, xa)
    tr.model._coupling_nn = counted
    tr.train_step(_batch(2), gen)
    assert len(calls) == 2 * 2 * 2       # blocks x flows x (fwd + recompute)
    calls.clear()
    tr.model.remat = False
    tr.train_step(_batch(3), gen)
    assert len(calls) == 2 * 2


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def test_remat_step_matches_jax_remat_step():
    """The port's remat train step from JAX's state after init_step against
    JAX's remat step, with JAX's dequantisation noise."""
    common = dict(n_flows=2, n_blocks=2, filter_size=16, lr=LR, remat=True)
    jc = JC.GlowConfig(
        data=JC.DataConfig(image_size=(HW, HW), batch_size=B,
                           normalize=False),
        run=JC.RunConfig(compute_dtype="float32"), **common)
    jt = JT(jc, (HW, HW, 3))
    st = jt.init(jax.random.PRNGKey(0))
    st = jt.init_step(st, jnp.asarray(_batch(1).numpy()),
                      jax.random.PRNGKey(1))
    before = jax.device_get(st)
    batch = _batch(2).numpy()
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.uniform(key, batch.shape))
    tr = PT(_pc(remat=True), (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    load_jax_glow_state(tr, before)
    after, m = jt.train_step(st, jnp.asarray(batch), key)
    after = jax.device_get(after)
    got = tr.train_step(torch.from_numpy(batch),
                        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=1e-5)
    want = from_jax_glow_params(_np(after.params), tr.model)
    _, mu, _ = _adam_leaves(after.opt_state)
    _, mu0, _ = _adam_leaves(before.opt_state)
    mu, mu0 = _flatten(_np(mu)), _flatten(_np(mu0))
    grads = {k: (mu[k] - 0.9 * mu0[k]) / 0.1 for k in mu}
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    for k, p in tr.model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k].numpy())
        g = np.abs(grads[k])
        real = (g >= REAL_GRAD_TENSOR * g.max()) & (g > REAL_GRAD_NET * gmax)
        assert not real.any() or diff[real].max() <= PARAM_ATOL, \
            (k, float(diff[real].max()))
        assert diff.max() <= NOISE_PARAM_ATOL, (k, float(diff.max()))


def test_run_glow_remat_trains_and_resumes(tmp_path):
    """run_glow with remat: the same losses as without it, a checkpoint
    that resumes exactly, and the CLI flag reaches the config."""
    def cfg(out, remat):
        c = _pc(remat=remat, fused_coupling=True)
        return dataclasses.replace(
            c, data=dataclasses.replace(c.data, dataset_size=20),
            run=dataclasses.replace(c.run, out_dir=str(out),
                                    sample_every_iters=2,
                                    checkpoint_every_iters=2))
    a = L.run_glow(cfg(tmp_path / "a", True), n_iter=4, device="cpu")
    b = L.run_glow(cfg(tmp_path / "b", False), n_iter=4, device="cpu")
    assert [r["loss"] for r in a["log"]] == [r["loss"] for r in b["log"]]
    back = L.run_glow(cfg(tmp_path / "a", True), n_iter=4, resume=True,
                      device="cpu")["trainer"]
    for k, v in a["trainer"].model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    assert back.step == a["trainer"].step == 4
