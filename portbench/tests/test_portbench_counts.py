"""The benchmark's operation counts against torch's FlopCounterMode of the
plain references, and its kernels' launch tables."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.flops import diffusion as FD
from portbench.flops import vaegan as FV
from portbench.reference import diffusion as RD
from portbench.reference import vaegan as RV
from portbench.reference.ops import exact, make_params


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc


def _ddpm(size, base, attention, batch=1):
    cfg = dict(harness.find_cell("ddpm256.train").config)
    cfg.update(image_size=size, base_ch=base, attention=attention,
               batch_size=batch)
    return cfg


@pytest.mark.parametrize("attention, gflop", [(True, 57.48867072),
                                              (False, 51.2811008)])
def test_unet_forward_flops_at_256(attention, gflop):
    cfg = _ddpm(256, 64, attention)
    p = {k: v.to("meta") for k, v in make_params(
        RD.param_specs(cfg), torch.Generator(), "cpu").items()}
    x = torch.empty(1, 256, 256, 3, device="meta")
    t = torch.zeros(1, dtype=torch.long, device="meta")
    with torch.no_grad():
        fc = _count(lambda: RD.unet(p, x, t, cfg))
    assert fc.get_total_flops() == FD.forward_flops(cfg, 1)
    assert FD.forward_flops(cfg, 1) / 1e9 == pytest.approx(gflop, rel=1e-9)


@pytest.mark.parametrize("attention", [True, False])
def test_unet_train_step_flops(attention):
    cfg = _ddpm(32, 8, attention, batch=2)
    p = make_params(RD.param_specs(cfg), torch.Generator(), "cpu")
    x = torch.randn(2, 32, 32, 3)
    t = torch.tensor([3, 500])

    def step():
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = RD.unet(leaves, x, t, cfg).square().mean()
        torch.autograd.grad(loss, list(leaves.values()))
    assert _count(step).get_total_flops() == FD.step_flops(cfg)


def test_vaegan_step_flops_at_64():
    cfg = dict(harness.find_cell("vaegan64.train").config, batch_size=2)
    p = make_params(RV.param_specs(cfg), torch.Generator(), "cpu")
    b = [torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8)]
    fc = _count(lambda: RV.train_steps(p, b, torch.Generator(), cfg, exact))
    assert fc.get_total_flops() == FV.step_flops(cfg)
    assert FV.step_flops(cfg) / 2 / 1e9 == pytest.approx(4.673045504,
                                                         rel=1e-9)


def test_attention_operations_match_the_reference_products():
    """K3's operations a forward are the reference forward's attention
    products (its only bmm calls)."""
    cfg = _ddpm(32, 8, True, batch=2)
    k3 = harness.find_cell("ddpm256.sample").module("kernels", "k3")
    p = make_params(RD.param_specs(cfg), torch.Generator(), "cpu")
    with torch.no_grad():
        fc = _count(lambda: RD.unet(p, torch.randn(2, 32, 32, 3),
                                    torch.tensor([1, 2]), cfg))
    bmm = fc.get_flop_counts()["Global"][torch.ops.aten.bmm]
    assert sum(ops for ops, _, _ in k3.launches(cfg, 2)) == bmm


def test_kernel_launch_tables():
    vc = harness.find_cell("vaegan64.train")
    dc = harness.find_cell("ddpm256.train")
    k1 = vc.module("kernels", "k1").launches(vc.config, 64)
    # 4 encoder layers x 2 forwards + 3 fused D stages x 5 forwards
    assert len(k1) == 23
    assert vc.module("kernels", "k1").launches(
        dict(vc.config, fused_conv=False), 64) == []
    k2 = dc.module("kernels", "k2").launches(dc.config, 16)
    assert len(k2) == 6
    assert all(dt == "tf32" for _, _, dt in k2)
    assert len(dc.module("kernels", "k3").launches(dc.config, 16)) == 3
    k4 = dc.module("kernels", "k4").launches(dc.config, 16)
    assert len(k4) == 14
    # a forward's K4 bytes by hand: elements n of each block's output,
    # gn1 reads and writes bf16 (4 n), gn2 adds a bf16 residual (6 n) but
    # the bottleneck's f32 one (8 n)
    n = [16 * 256 * 256 * 64, 16 * 128 * 128 * 128, 16 * 64 * 64 * 256,
         16 * 32 * 32 * 256, 16 * 64 * 64 * 128, 16 * 128 * 128 * 64,
         16 * 256 * 256 * 64]
    want = sum(4 * x + 6 * x for x in n) + 2 * n[3]
    assert sum(b for _, b, _ in k4) == want == 2 ** 31
