"""Port kernels on the card: each kernel against its plain PyTorch version,
ragged shapes included, and the UNet (fused and training forms) against
the same weights run with no kernel (``kernels.plain_reference``). Marked
``gpu``; skipped (inside the fixture, never at import) where no CUDA card is
visible. Run on a machine with a card:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX, which a machine with
only the port need not have.)
"""
import pytest
import torch

from vgd_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from vgd_tpu_torch.core.rng import resolve_device
    return resolve_device("cuda")


@pytest.mark.parametrize("b,n,m,d", [(2, 256, 64, 256), (2, 1024, 1024, 256),
                                     (3, 100, 70, 64), (1, 129, 33, 128),
                                     (2, 64, 1, 256)])
def test_flash_attention_matches_plain(cuda, b, n, m, d):
    """f32 both sides; atol 1e-4 covers the online-softmax summation
    order."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, d, device=cuda, generator=g)
               for s in (n, m, m))
    before = K.LAUNCHES["flash_attention"]
    out = K.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out, K.attention_plain(q, k, v), atol=1e-4,
                               rtol=0)


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    q = torch.randn(1, 64, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        K.flash_attention(q, q, q)
    q = torch.randn(1, 64, 256, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        K.flash_attention(q.half(), q.half(), q.half())
    strided = torch.randn(1, 256, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention(strided, q, q)
    with pytest.raises(ValueError):
        K.flash_attention(q, q.cpu(), q)


@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (2, 32, 32, 256),
                                   (3, 7, 9, 24), (1, 1, 1, 8)])
def test_groupnorm_silu_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    c = shape[-1]
    x = torch.randn(*shape, device=cuda, generator=g) * 3.0 + 1.0
    scale = torch.randn(c, device=cuda, generator=g)
    bias = torch.randn(c, device=cuda, generator=g)
    out = K.groupnorm_silu(x, scale, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, K.groupnorm_silu_plain(x, scale, bias),
                               atol=1e-4, rtol=0)


def test_fused_unet_matches_plain_f32(cuda):
    """Small f32 UNet: kernels inside the model agree with the same model
    run with no kernel at all."""
    from vgd_tpu_torch.models.unet import UNet
    g = torch.Generator(device=cuda).manual_seed(2)
    with torch.device(cuda):
        fused = UNet(base_ch=16, time_emb_dim=32, fused=True)
        fused.init_parameters(g)
    x = torch.randn(2, 32, 32, 3, device=cuda, generator=g)
    t = torch.tensor([5, 900], device=cuda)
    with torch.inference_mode():
        K.LAUNCHES.clear()
        with K.plain_reference():
            ref = fused(x, t)
        assert sum(K.LAUNCHES.values()) == 0
        torch.testing.assert_close(fused(x, t), ref, atol=2e-4, rtol=0)
    assert K.LAUNCHES["flash_attention"] == 3


K2_SHAPES = [(2, 256, 64, 256), (2, 1024, 1024, 256), (3, 1000, 70, 256),
             (1, 129, 33, 128), (2, 100, 40, 64), (2, 64, 1, 256),
             (16, 4096, 64, 256)]


@pytest.mark.parametrize("b,n,m,d", K2_SHAPES)
def test_k2_kernels_match_plain(cuda, b, n, m, d):
    """Forward (o, lse), dq and dk/dv against the plain versions, f32 both
    sides: o and lse atol 1e-4 (summation order of the online softmax);
    gradients 1e-4 relative to max |.| of the plain result, since dk/dv sum
    over up to N rows (the last shape runs the split dk/dv path), plus 1e-5
    absolute for O(1) inputs: with one key (M=1) p = 1 and dp = delta, so
    dq is zero in exact arithmetic and f32 noise on both sides."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(b, s, d, device=cuda, generator=g)
                   for s in (n, m, m, n))
    scale = d ** -0.5
    before = dict(K.LAUNCHES)
    o, lse = K.attention_fwd_lse(q, k, v, scale)
    grads = K.attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    for name in ("attention_fwd", "attention_dq", "attention_dkv"):
        assert K.LAUNCHES[name] == before.get(name, 0) + 1
    ro, rlse = K.attention_fwd_lse_plain(q, k, v, scale)
    torch.testing.assert_close(o, ro, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    refs = K.attention_bwd_plain(q, k, v, ro, rlse, do, scale)
    for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
        err = float((a - r).abs().max())
        assert err <= 1e-4 * float(r.abs().max()) + 1e-5, (name, err)


def test_k2_autograd_matches_plain_autograd(cuda):
    """The autograd.Function on the card against autograd through the plain
    attention, with k/v expanded over the batch as in the cross-attention
    (the gradient reaches the one projection summed over the batch)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(4, 300, 256, device=cuda, generator=g)
    kv = torch.randn(1, 64, 512, device=cuda, generator=g)
    grads = []
    for plain in (False, True):
        src = kv.clone().requires_grad_()
        qq = q.clone().requires_grad_()
        k, v = (t.expand(4, -1, -1).contiguous() for t in src.split(256, -1))
        if plain:
            with K.plain_reference():
                out = K.attention(qq, k, v)
        else:
            out = K.attention(qq, k, v)
        torch.sin(out).sum().backward()
        grads.append((qq.grad, src.grad))
    for a, r in zip(*grads):
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_k2_refuses_what_it_cannot_take(cuda):
    q = torch.randn(1, 64, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        K.attention_fwd_lse(q, q, q, 1.0)
    q = torch.randn(1, 64, 256, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        K.attention_fwd_lse(q.half(), q.half(), q.half(), 1.0)
    strided = torch.randn(1, 256, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.attention_fwd_lse(strided, q, q, 1.0)
    with pytest.raises(ValueError):
        K.attention_fwd_lse(q, q.cpu(), q, 1.0)
    o, lse = K.attention_fwd_lse(q, q, q, 1.0)
    with pytest.raises(ValueError, match="lse"):
        K.attention_bwd(q, q, q, o, lse[:, :32].contiguous(), q, 1.0)


def test_training_unet_matches_kernel_free_reference(cuda):
    """Small f32 training-form UNet: loss and every gradient with K2 agree
    with the same weights run with no kernel (plain attention under
    autograd); 1e-3 of each tensor's max |g| plus 1e-6 of the largest,
    since several gradients are zero in exact arithmetic."""
    from vgd_tpu_torch.models.unet import UNet
    g = torch.Generator(device=cuda).manual_seed(5)
    with torch.device(cuda):
        model = UNet(base_ch=16, time_emb_dim=32, fused=False)
        model.init_parameters(g)
    x = torch.randn(2, 32, 32, 3, device=cuda, generator=g)
    t = torch.tensor([5, 900], device=cuda)
    out = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        K.LAUNCHES.clear()
        if plain:
            with K.plain_reference():
                loss = model(x, t).square().mean()
                loss.backward()
            assert sum(K.LAUNCHES.values()) == 0
        else:
            loss = model(x, t).square().mean()
            loss.backward()
            assert K.LAUNCHES["attention_dkv"] == 3
        out.append((float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    gmax = max(float(v.abs().max()) for v in out[1][1].values())
    for name, ref in out[1][1].items():
        err = float((out[0][1][name] - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()) + 1e-6 * gmax, name
