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


K1_SHAPES = [(2, 16, 16, 8, 32, 0), (2, 16, 16, 8, 32, 1),
             (3, 31, 29, 5, 7, 0), (2, 9, 13, 12, 20, 1),
             (4, 127, 127, 32, 64, 0), (4, 8, 8, 256, 512, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,w,cin,k,pad", K1_SHAPES)
def test_k1_matches_plain(cuda, b, h, w, cin, k, pad, dtype):
    """K1 (conv + batch statistics) against its plain version on the same
    operands (the plain one upcasts bf16 to f32; TF32 is off): c within
    1e-4 of max |c| (the sums run in other orders), mean / var rtol 1e-4
    atol 1e-5. Odd, ragged and unvectorisable (Cin 5, K 7) shapes included."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(b, h, w, cin, device=cuda, generator=g).to(dtype)
    wt = (0.1 * torch.randn(k, cin, 4, 4, device=cuda, generator=g)).to(dtype)
    before = K.LAUNCHES["conv_bn_stats"]
    c, mean, var = K.conv_stats(x, wt, pad)
    torch.cuda.synchronize()
    assert K.LAUNCHES["conv_bn_stats"] == before + 1
    rc, rm, rv = K.conv_stats_plain(x, wt, pad)
    assert c.shape == rc.shape and c.dtype == torch.float32
    assert float((c - rc).abs().max()) <= 1e-4 * float(rc.abs().max())
    torch.testing.assert_close(mean, rm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var, rv, rtol=1e-4, atol=1e-5)


def test_k1_autograd_matches_plain_autograd(cuda):
    """The fused op with K1 and its custom backward against the unfused plain
    chain under autograd (``conv_bn_lrelu_plain``), f32: y, mean, var and
    the gradients of x, w, gamma and beta; the conv bias gets an exact zero.
    Inside ``plain_reference`` the fused op launches nothing."""
    from vgd_tpu_torch.ops.fused_conv import conv_bn_lrelu, conv_bn_lrelu_plain
    g = torch.Generator(device=cuda).manual_seed(7)
    x0 = torch.randn(4, 31, 31, 16, device=cuda, generator=g)
    w0 = 0.1 * torch.randn(32, 16, 4, 4, device=cuda, generator=g)
    gamma0 = 1 + 0.1 * torch.randn(32, device=cuda, generator=g)
    beta0 = 0.1 * torch.randn(32, device=cuda, generator=g)
    bias0 = torch.linspace(-1, 1, 32, device=cuda)
    cot = torch.randn(4, 14, 14, 32, device=cuda, generator=g)
    out = []
    for fn in (conv_bn_lrelu, conv_bn_lrelu_plain):
        args = [t.clone().requires_grad_() for t in (x0, w0, gamma0, beta0,
                                                     bias0)]
        K.LAUNCHES.clear()
        y, m, v = fn(*args[:4], bias=args[4], slope=0.01)
        assert K.LAUNCHES["conv_bn_stats"] == (fn is conv_bn_lrelu)
        y.backward(cot)
        out.append(((y, m, v), [a.grad for a in args]))
    for a, r in zip(out[0][0], out[1][0]):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
    for a, r in zip(out[0][1][:4], out[1][1][:4]):
        assert float((a - r).abs().max()) <= 2e-4 * float(r.abs().max())
    assert torch.equal(out[0][1][4], torch.zeros_like(bias0))
    K.LAUNCHES.clear()
    with K.plain_reference():
        conv_bn_lrelu(x0, w0, gamma0, beta0, bias=bias0)
    assert sum(K.LAUNCHES.values()) == 0


def test_k1_refuses_what_it_cannot_take(cuda):
    x = torch.randn(2, 16, 16, 8, device=cuda)
    w = torch.randn(16, 8, 4, 4, device=cuda)
    strided = torch.randn(2, 8, 16, 16, device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.conv_stats(strided, w, 1)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        K.conv_stats(x.half(), w.half(), 1)
    with pytest.raises(ValueError, match="w is"):
        K.conv_stats(x, w.bfloat16(), 1)
    with pytest.raises(ValueError, match="padding"):
        K.conv_stats(x, w, 2)
    with pytest.raises(ValueError, match="shape"):
        K.conv_stats(x, torch.randn(16, 8, 3, 3, device=cuda), 1)
    with pytest.raises(ValueError):
        K.conv_stats(x, w.cpu(), 1)


def test_vaegan_step_fused_matches_stock_on_the_card(cuda):
    """A small f32 VAE-GAN train step with K1 (fused_conv) and the same
    weights and draws through the stock layers: the five losses agree and
    every step launches K1 exactly 4 + 2 * 2 * 3 + 4 + 3 = 23 times at
    64x64 (4 fused encoder layers, 3 fused discriminator layers)."""
    import dataclasses
    from vgd_tpu_torch.core import config as C
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    cfg = C.VAEGANConfig(
        data=C.DataConfig(image_size=(64, 64), batch_size=4),
        run=C.RunConfig(compute_dtype="float32", fused_conv=True),
        latent_dim=16, ngf=8, ndf=8)
    g = torch.Generator(device=cuda).manual_seed(8)
    batch = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                          device=cuda, generator=g)
    draws = dict(eps=torch.randn(4, 16, device=cuda, generator=g),
                 noise_real=torch.randn(4, 64, 64, 3, device=cuda,
                                        generator=g),
                 noise_fake=torch.randn(4, 64, 64, 3, device=cuda,
                                        generator=g))
    fused = VAEGANTrainer(cfg, (64, 64, 3), device="cuda")
    fused.init(torch.Generator(device=cuda).manual_seed(0))
    stock = VAEGANTrainer(dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, fused_conv=False)), (64, 64, 3), device="cuda")
    stock.load(fused.state_dict())
    K.LAUNCHES.clear()
    mf = fused.train_step(batch, 0.5, **draws)
    assert K.LAUNCHES["conv_bn_stats"] == 23
    ms = stock.train_step(batch, 0.5, **draws)
    assert K.LAUNCHES["conv_bn_stats"] == 23
    for k in mf:
        assert abs(float(mf[k]) - float(ms[k])) <= 1e-4 * abs(float(ms[k])), k
