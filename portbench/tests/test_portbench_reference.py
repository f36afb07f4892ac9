"""The plain references against ``vgd_tpu_torch`` at tiny sizes in f32, on
the same weights, batches and draws."""
import math

import torch

from portbench import harness
from portbench.reference import diffusion as RD
from portbench.reference import vaegan as RV
from portbench.reference.ops import exact, fp8, make_params


def _cfg(cell, **kw):
    cfg = dict(harness.find_cell(cell).config)
    cfg.update(compute_dtype="float32", **kw)
    return cfg


def _close(a, b, tol):
    return abs(a - b) <= tol * max(abs(b), 1e-6)


def test_vaegan_steps_match_the_program():
    cell = harness.find_cell("vaegan64.train")
    cfg = _cfg("vaegan64.train", batch_size=4, latent_dim=16, ngf=8, ndf=8,
               dataset_size=12)
    p = make_params(RV.param_specs(cfg), torch.Generator().manual_seed(1),
                    "cpu")
    system = cell.module("families").TrainSystem(cfg, (64, 64, 3), p, 5,
                                                 torch.device("cpu"))
    g = torch.Generator().manual_seed(2)
    batches = [torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                             generator=g) for _ in range(3)]
    prog = [{k: float(v) for k, v in system.step_fn(b).items()}
            for b in batches]
    ref_p = {k: v.clone() for k, v in p.items()}
    ref = RV.train_steps(ref_p, batches, torch.Generator().manual_seed(5),
                         cfg, exact)
    for a, b in zip(prog, ref):
        assert set(a) == set(b)
        assert all(_close(a[k], b[k], 1e-5) for k in b), (a, b)
    leaves = system.leaves()
    moved = [k for k in leaves if "bias" not in k or "bn" in k]
    for k in moved:
        assert torch.allclose(leaves[k], ref_p[k], atol=2e-4, rtol=0), k


def test_unet_forward_and_ddpm_step_match_the_program():
    cell = harness.find_cell("ddpm256.train")
    cfg = _cfg("ddpm256.train", image_size=32, base_ch=8, time_emb_dim=32,
               batch_size=2)
    p = make_params(RD.param_specs(cfg), torch.Generator().manual_seed(3),
                    "cpu")
    system = cell.module("families").TrainSystem(cfg, (32, 32, 3), p, 9,
                                                 torch.device("cpu"))
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    t = torch.tensor([7, 900])
    with torch.no_grad():
        got = system.trainer.model(x, t)
        want = RD.unet(p, x, t, cfg)
    assert (got - want).norm() <= 1e-5 * want.norm()
    batch = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(6))
    loss = float(system.step_fn(batch)["loss"])
    ref = RD.train_steps({k: v.clone() for k, v in p.items()}, [batch],
                         torch.Generator().manual_seed(9), cfg, exact)
    assert _close(loss, ref[0]["loss"], 1e-5)


def test_ddim_chain_matches_the_program():
    cell = harness.find_cell("ddpm256.sample")
    cfg = _cfg("ddpm256.sample", image_size=32, base_ch=8, time_emb_dim=32)
    p = make_params(RD.param_specs(cfg), torch.Generator().manual_seed(8),
                    "cpu")
    request, _ = cell.module("families").sampler(cfg, p, 1,
                                                 torch.device("cpu"))
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    got = request(x, 10, 0.0)
    want = RD.ddim_sample(p, x, 10, cfg)
    # the untrained chain amplifies f32 rounding (x grows as 1 / sqrt(abar))
    assert (got - want).norm() <= 1e-4 * want.norm()
    assert (got - want).abs().max() <= 1e-2


def test_fp8_rounds_operands_and_gradients():
    x = torch.randn(64, requires_grad=True)
    y = fp8(x)
    assert 0 < (y - x).abs().max() <= 2 ** -3 * x.abs().max()
    y.sum().backward()
    assert torch.allclose(x.grad, torch.ones(64))
    assert exact(x) is x
    assert math.isfinite(float(y.sum()))
