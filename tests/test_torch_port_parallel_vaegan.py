"""A data-parallel VAE-GAN step of the port against the JAX package's on
a data=2 mesh (CPU, f32, 64x64, batch 4, ngf = ndf = 8, latent 16, the
fused K1 path): JAX's jitted step with its state replicated and its batch
sharded over two of the virtual CPU devices, and the port's step on two
gloo ranks (``parallel.launch.spawn`` running
``parallel.workers.vaegan_step``) from the same state (over
``io.jax_params``) with JAX's draws. The tolerances are the one-device
lockstep test's (``tests/test_torch_port_vaegan.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.parallel import mesh as JM
from vgd_tpu.train.vaegan import VAEGANTrainer as JT
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.jax_params import load_jax_vaegan_state
from vgd_tpu_torch.parallel.launch import spawn
from vgd_tpu_torch.train.vaegan import VAEGANTrainer as PT

HW, LAT, LR, RAMP, VB = 64, 16, 2e-4, 0.5, 4
LOSS_RTOL, STAT_TOL = 1e-5, dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL, NOISE_PARAM_ATOL = 1e-4, 2 * LR


def test_vaegan_dp_step_matches_jax_data_mesh():
    """One VAE-GAN step (fused_conv) of JAX's jitted step with its state
    and batch on a data=2 mesh against the port's step on 2 ranks from the
    same state (over ``io.jax_params``) with JAX's draws: the five losses,
    every BN stat and every parameter (the one-device lockstep test's
    tolerances: real parameters within 1e-4, the rest within 2 lr), and
    the two ranks' states bit-equal."""
    common = dict(latent_dim=LAT, ngf=8, ndf=8, lr=LR)
    jc = JC.VAEGANConfig(
        data=JC.DataConfig(image_size=(HW, HW), batch_size=VB),
        run=JC.RunConfig(compute_dtype="float32", fused_conv=True), **common)
    pc = PC.VAEGANConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=VB),
        run=PC.RunConfig(compute_dtype="float32", fused_conv=True), **common)
    jt = JT(jc, (HW, HW, 3))
    st = jt.init(jax.random.PRNGKey(0), VB)
    batch = np.random.default_rng(100).integers(0, 256, (VB, HW, HW, 3),
                                                dtype=np.uint8)
    key = jax.random.PRNGKey(100)
    k_eps, k_nr, k_nf = jax.random.split(key, 3)
    draws = {"eps": np.array(jax.random.normal(k_eps, (VB, LAT))),
             **{n: np.array(jax.random.normal(k, (VB, HW, HW, 3)))
                for n, k in (("noise_real", k_nr), ("noise_fake", k_nf))}}
    # the port's copy first: the JAX step donates its state
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    tr = load_jax_vaegan_state(tr, st)
    mesh = JM.build_mesh(2, 1, devices=jax.devices()[:2])
    after, metrics = jt.train_step(JM.shard_tree_replicated(mesh, st),
                                   JM.shard_batch(mesh, jnp.asarray(batch)),
                                   key, jnp.float32(RAMP))
    after = jax.device_get(after)
    ref = PT(pc, (HW, HW, 3), device="cpu")
    ref.init(torch.Generator().manual_seed(0))
    want = load_jax_vaegan_state(ref, after).state_dict()
    parts = spawn("vgd_tpu_torch.parallel.workers:vaegan_step", 2, pc,
                  (HW, HW, 3), {"params": tr.state_dict(),
                                "opt_state": tr.opt_state(), "step": 0},
                  torch.from_numpy(batch),
                  {k: torch.from_numpy(v) for k, v in draws.items()}, RAMP)
    assert parts[0]["fingerprint"] == parts[1]["fingerprint"]
    for k, v in parts[0]["metrics"].items():
        np.testing.assert_allclose(v, float(metrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    got = parts[0]["params"]
    for k, ref in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(),
                                       **STAT_TOL, err_msg=k)
        else:
            err = float((got[k] - ref).abs().max())
            assert err <= NOISE_PARAM_ATOL, (k, err)
    # parameters that a real gradient moved: within PARAM_ATOL
    moved = [k for k in want if "running" not in k and
             float((want[k] - tr.state_dict()[k]).abs().max()) > LR / 2]
    assert moved
    for k in moved:
        assert float((got[k] - want[k]).abs().max()) <= PARAM_ATOL, k
