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

import chip_smoke
from vgd_tpu_torch.ops import _build, kernels as K

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


# the three training shapes of the 256x256, batch-16 UNet (cross_attn2,
# cross_attn3, the bottleneck), the two ragged ones of chip_smoke.py, and
# smaller and degenerate ones
K2_SHAPES = [(16, 16384, 64, 256), (16, 4096, 64, 256), (16, 1024, 1024, 256),
             (3, 1000, 70, 256), (2, 129, 33, 128),
             (2, 256, 64, 256), (2, 1024, 1024, 256), (1, 129, 33, 128),
             (2, 100, 40, 64), (2, 64, 1, 256)]


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


def test_k2_autograd_matches_plain_autograd(cuda, monkeypatch):
    """The autograd.Function on the card (past the size gate) against
    autograd through the plain attention, with k/v expanded over the batch
    as in the cross-attention (the gradient reaches the one projection
    summed over the batch)."""
    monkeypatch.setattr(K, "MIN_FLASH_ELEMS", 0)
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
    # the backward kernels stream their tiles with 16-byte cp.async copies
    delta = (q * o).sum(-1)
    shifted = torch.empty(64 * 256 + 1, device=cuda)[1:].view(1, 64, 256)
    with pytest.raises(ValueError, match="aligned"):
        K.attention_dq(q, q, q, shifted, lse, delta, 1.0)
    with pytest.raises(ValueError, match="aligned"):
        K.attention_dkv(shifted, q, q, q, lse, delta, 1.0)
    with pytest.raises(ValueError, match="delta"):
        K.attention_dkv(q, q, q, q, lse, delta[:, :32].contiguous(), 1.0)


@pytest.mark.parametrize("b,n,m,d", [(16, 4096, 64, 256),
                                     (2, 1024, 1024, 256),
                                     (3, 1000, 70, 256), (1, 129, 33, 128)])
def test_k2_backward_is_bit_deterministic(cuda, b, n, m, d):
    """dq, dk and dv are bit-equal from call to call: no atomics, and the
    split dk/dv partials are summed in a fixed order."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(b, s, d, device=cuda, generator=g)
                   for s in (n, m, m, n))
    scale = d ** -0.5
    o, lse = K.attention_fwd_lse(q, k, v, scale)
    delta = (do * o).sum(-1)
    first = (K.attention_dq(q, k, v, do, lse, delta, scale),
             *K.attention_dkv(q, k, v, do, lse, delta, scale))
    again = (K.attention_dq(q, k, v, do, lse, delta, scale),
             *K.attention_dkv(q, k, v, do, lse, delta, scale))
    for name, a, r in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, r), name


def test_training_unet_matches_kernel_free_reference(cuda, monkeypatch):
    """Small f32 training-form UNet: loss and every gradient with K2 (its
    three attentions past the size gate) agree with the same weights run
    with no kernel (plain attention under autograd); 1e-3 of each tensor's
    max |g| plus 1e-6 of the largest, since several gradients are zero in
    exact arithmetic."""
    monkeypatch.setattr(K, "MIN_FLASH_ELEMS", 0)
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


# K5 at the reference Glow's four coupling shapes (B=16, f=512; ya has half
# the squeezed channels) and two ragged ones (odd sizes, channels no tile
# divides)
# the four block shapes, then sizes no tile divides: pixel counts no
# multiple of 64 or 128, f = 40 and 72, odd and even channel counts; the
# last two are large enough for the 128-row tiles (wgmma for conv2, dh1)
K5_SHAPES = [(16, 32, 32, 6, 512), (16, 16, 16, 12, 512),
             (16, 8, 8, 24, 512), (16, 4, 4, 48, 512),
             (3, 7, 5, 5, 40), (2, 9, 13, 11, 72), (3, 5, 9, 6, 40),
             (1, 129, 127, 6, 72), (1, 127, 129, 5, 40)]


def k5_inputs(cuda, b, h, w, cin, f, dtype, seed):
    """Packed K5 operands from HWIO weights with a non-zero ZeroConv."""
    from vgd_tpu_torch.ops.glow_coupling import prep
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, s=1.0):
        return s * torch.randn(*shape, device=cuda, generator=g)
    p = prep(rnd(b, h, w, cin), rnd(3, 3, cin, f, s=0.05),
             rnd(1, 1, f, f, s=0.05), rnd(3, 3, f, cin, s=0.01), dtype)
    vec = dict(b1=rnd(f, s=0.05), b2=rnd(f, s=0.05), bz=rnd(cin, s=0.02),
               scale=rnd(cin, s=0.1), g=rnd(b, h, w, cin))
    return p, vec


def k5_close(got, ref, rel, what):
    """got within rel * max |ref| of ref, except where one side is exactly
    zero and the other is not: a ReLU mask that flips on an f32-ulp
    difference of a pre-activation within rounding of 0 (at most 1e-5 of
    the elements)."""
    got, ref = got.float(), ref.float()
    flip = (got == 0) != (ref == 0)
    assert int(flip.sum()) <= 1e-5 * ref.numel(), (what, int(flip.sum()))
    err = float(torch.where(flip, 0.0, (got - ref).abs()).max())
    assert err <= rel * float(ref.abs().max()) + 1e-6, (what, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,w,cin,f", K5_SHAPES)
def test_k5_kernels_match_plain(cuda, b, h, w, cin, f, dtype):
    """K5 forward, backward 1 and backward 2 against their plain versions on
    the same operands (backward 2 fed the plain h1 and dh2): f32 at 1e-4 of
    max |.| (sums in other orders); bf16 at 2e-2 of max |.|, since an h1 or
    h2 rounding to bf16 flips on an f32-ulp difference."""
    p, v = k5_inputs(cuda, b, h, w, cin, f, dtype, 9)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    khw, pad = (3, 3), (1, 1)
    fwd_args = (p["ya"], p["w1f"], v["b1"], p["w2"], v["b2"], p["wz"])
    before = dict(K.LAUNCHES)
    out = K.glow_coupling_fwd(*fwd_args, v["bz"], v["scale"], khw, pad)
    got1 = K.glow_coupling_bwd1(*fwd_args, p["wzf"], v["bz"], v["scale"],
                                v["g"], khw, pad)
    torch.cuda.synchronize()
    k5_close(out, K.glow_coupling_fwd_plain(*fwd_args, v["bz"], v["scale"],
                                            khw, pad), rel, "out")
    ref1 = K.glow_coupling_bwd1_plain(*fwd_args, p["wzf"], v["bz"],
                                      v["scale"], v["g"], khw, pad)
    for name, a, r in zip(("h1", "dh2", "dwz", "dbz", "db2", "dscale"),
                          got1, ref1):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        k5_close(a, r, rel, name)
    got2 = K.glow_coupling_bwd2(p["ya"], p["w1t"], p["w2t"], ref1[0],
                                ref1[1], khw, pad)
    torch.cuda.synchronize()
    ref2 = K.glow_coupling_bwd2_plain(p["ya"], p["w1t"], p["w2t"], ref1[0],
                                      ref1[1], khw, pad)
    for name, a, r in zip(("dya", "dw1", "db1", "dw2"), got2, ref2):
        k5_close(a, r, rel, name)
    for name in ("glow_coupling_fwd", "glow_coupling_bwd1",
                 "glow_coupling_bwd2"):
        assert K.LAUNCHES[name] == before.get(name, 0) + 1


def test_k5_is_deterministic_and_refuses_what_it_cannot_take(cuda):
    p, v = k5_inputs(cuda, 4, 16, 16, 6, 64, torch.bfloat16, 10)
    args = (p["ya"], p["w1f"], v["b1"], p["w2"], v["b2"], p["wz"],
            p["wzf"], v["bz"], v["scale"], v["g"], (3, 3), (1, 1))
    a, b = K.glow_coupling_bwd1(*args), K.glow_coupling_bwd1(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # backward 2 too: its split and column sums run in a fixed order
    args2 = (p["ya"], p["w1t"], p["w2t"], a[0], a[1], (3, 3), (1, 1))
    a2, b2 = K.glow_coupling_bwd2(*args2), K.glow_coupling_bwd2(*args2)
    assert all(torch.equal(x, y) for x, y in zip(a2, b2))
    with pytest.raises(ValueError, match="same"):
        K.glow_coupling_fwd(*args[:6], v["bz"], v["scale"], (3, 3), (0, 0))
    with pytest.raises(ValueError, match="w2"):
        K.glow_coupling_fwd(p["ya"], p["w1f"], v["b1"], p["w2"].float(),
                            v["b2"], p["wz"], v["bz"], v["scale"], (3, 3),
                            (1, 1))
    with pytest.raises(ValueError, match="contiguous"):
        K.glow_coupling_fwd(p["ya"], p["w1f"], v["b1"], p["w2t"].t(),
                            v["b2"], p["wz"], v["bz"], v["scale"], (3, 3),
                            (1, 1))
    with pytest.raises(ValueError):
        K.glow_coupling_fwd(p["ya"].cpu(), p["w1f"], v["b1"], p["w2"],
                            v["b2"], p["wz"], v["bz"], v["scale"], (3, 3),
                            (1, 1))
    # the bf16 tiles read f-wide operands in 16-byte runs
    q, u = k5_inputs(cuda, 2, 4, 4, 6, 60, torch.bfloat16, 11)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.glow_coupling_fwd(q["ya"], q["w1f"], u["b1"], q["w2"], u["b2"],
                            q["wz"], u["bz"], u["scale"], (3, 3), (1, 1))


def test_glow_step_fused_matches_kernel_free_reference(cuda):
    """A small f32 Glow (2 blocks of 3 flows, f = 64, 16x16, batch 4) with
    fused_coupling: loss and every gradient with K5 agree with the same
    weights run with no kernel (1e-4 of each tensor's max |g| plus 1e-6 of
    the largest); one K5 launch of each kind per coupling."""
    from vgd_tpu_torch.core import config as C
    from vgd_tpu_torch.train.glow import GlowTrainer
    cfg = C.GlowConfig(data=C.DataConfig(image_size=(16, 16), batch_size=4),
                       run=C.RunConfig(compute_dtype="float32"), n_flows=3,
                       n_blocks=2, filter_size=64, fused_coupling=True)
    tr = GlowTrainer(cfg, (16, 16, 3), device="cuda")
    g = torch.Generator(device=cuda).manual_seed(11)
    tr.init(g)
    batch = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8,
                          device=cuda, generator=g)
    noise = torch.rand(4, 16, 16, 3, device=cuda, generator=g)
    K.LAUNCHES.clear()
    tr.init_step(batch, noise=noise)
    assert K.LAUNCHES["glow_coupling_fwd"] == 6
    with torch.no_grad():       # a trained-like, non-zero ZeroConv
        for blk in tr.model.blocks():
            for t in blk.flows.coupling.zero.parameters():
                t.copy_(0.01 * torch.randn(t.shape, device=cuda, generator=g))
    x = tr._prep(batch, None, noise)
    out = []
    for plain in (False, True):
        tr.model.zero_grad(set_to_none=True)
        K.LAUNCHES.clear()
        if plain:
            with K.plain_reference():
                lp, ld, _ = tr.model(x)
                (-(lp.mean() + ld)).backward()
            assert sum(K.LAUNCHES.values()) == 0
        else:
            lp, ld, _ = tr.model(x)
            (-(lp.mean() + ld)).backward()
            assert {k: K.LAUNCHES[k] for k in (
                "glow_coupling_fwd", "glow_coupling_bwd1",
                "glow_coupling_bwd2")} == dict.fromkeys(
                ("glow_coupling_fwd", "glow_coupling_bwd1",
                 "glow_coupling_bwd2"), 6)
        out.append((float(lp.mean()), {n: p.grad.clone() for n, p in
                                       tr.model.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    gmax = max(float(v.abs().max()) for v in out[1][1].values())
    for name, ref in out[1][1].items():
        err = float((out[0][1][name] - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()) + 1e-6 * gmax, name


# K6 at small shapes: (B, H, W, c, f, flows, kernel)
K6_SHAPES = [(2, 8, 8, 12, 64, 3, (3, 3)), (3, 7, 5, 10, 40, 3, (3, 3)),
             (2, 16, 1, 22, 32, 2, (3, 1))]


def k6_inputs(cuda, b, h, w, c, f, n, khw, dtype, seed):
    """K6's forward and backward operands from stacked leaves (an
    orthogonal 1x1 conv, a non-zero ZeroConv), packed."""
    from vgd_tpu_torch.ops.glow_flow_stack import _pack
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, s=1.0):
        return s * torch.randn(*shape, device=cuda, generator=g)
    kh, kw = khw
    ch = c // 2
    q, _ = torch.linalg.qr(rnd(n, c, c))
    p = _pack(rnd(n, kh, kw, ch, f, s=0.05), rnd(n, 1, 1, f, f, s=0.05),
              rnd(n, kh, kw, f, ch, s=0.01), dtype, backward=True)
    an_b, an_s = rnd(n, c, s=0.1), torch.exp(rnd(n, c, s=0.1))
    wt = q.transpose(1, 2).contiguous()
    b1, b2 = rnd(n, f, s=0.05), rnd(n, f, s=0.05)
    bz, sc = rnd(n, ch, s=0.02), rnd(n, ch, s=0.1)
    fwd = (rnd(b, h, w, c), an_b, an_s, wt, p["w1f"], b1, p["w2"], b2,
           p["wz"], bz, sc)
    bwd = (an_b, an_s, wt, p["w1f"], p["w1t"], b1, p["w2"], p["w2t"], b2,
           p["wz"], p["wzf"], bz, sc, rnd(b, h, w, c))
    return fwd, bwd


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,w,c,f,n,khw", K6_SHAPES)
def test_k6_kernels_match_plain(cuda, b, h, w, c, f, n, khw, dtype):
    """K6 forward (with and without saves) and backward (fed the plain
    saved inputs) against the plain versions: f32 at 1e-4 of max |.| for
    the values and 5e-4 for the gradients (sums in other orders, as the
    JAX flow-stack test), bf16 at K5's 2e-2 of max |.|. The no-save y
    equals the saving one bit for bit; one launch of each."""
    fa, ba = k6_inputs(cuda, b, h, w, c, f, n, khw, dtype, 12)
    pad = (khw[0] // 2, khw[1] // 2)
    bf16 = dtype == torch.bfloat16
    before = dict(K.LAUNCHES)
    y, xsave = K.glow_flow_stack_fwd(*fa, khw, pad, True)
    y_ns = K.glow_flow_stack_fwd(*fa, khw, pad, False)
    ref_y, ref_xsave = K.glow_flow_stack_fwd_plain(*fa, khw, pad, True)
    got = K.glow_flow_stack_bwd(ref_xsave, *ba, khw, pad)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ns)
    k5_close(y, ref_y, 2e-2 if bf16 else 1e-4, "y")
    k5_close(xsave, ref_xsave, 2e-2 if bf16 else 1e-4, "xsave")
    ref = K.glow_flow_stack_bwd_plain(ref_xsave, *ba, khw, pad)
    for name, a, r in zip(("dx", "danb", "dans", "dwt", "dw1", "db1", "dw2",
                           "db2", "dwz", "dbz", "dscale"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        k5_close(a, r, 2e-2 if bf16 else 5e-4, name)
    for name in ("glow_flow_stack_fwd", "glow_flow_stack_fwd_nosave",
                 "glow_flow_stack_bwd"):
        assert K.LAUNCHES[name] == before.get(name, 0) + 1


def test_k6_is_deterministic_and_refuses_what_it_cannot_take(cuda):
    fa, ba = k6_inputs(cuda, 2, 8, 8, 12, 64, 2, (3, 3), torch.bfloat16, 13)
    y, xsave = K.glow_flow_stack_fwd(*fa, (3, 3), (1, 1), True)
    a = K.glow_flow_stack_bwd(xsave, *ba, (3, 3), (1, 1))
    b = K.glow_flow_stack_bwd(xsave, *ba, (3, 3), (1, 1))
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    with pytest.raises(ValueError, match="same"):
        K.glow_flow_stack_fwd(*fa, (3, 3), (0, 0), False)
    with pytest.raises(ValueError, match="w2"):
        K.glow_flow_stack_fwd(*fa[:6], fa[6].float(), *fa[7:], (3, 3),
                              (1, 1), False)
    with pytest.raises(ValueError, match="contiguous"):
        K.glow_flow_stack_fwd(fa[0].transpose(1, 2), *fa[1:], (3, 3),
                              (1, 1), False)
    with pytest.raises(ValueError, match="aligned"):
        w1f = torch.empty(fa[4].numel() + 1, dtype=fa[4].dtype,
                          device=cuda)[1:].view(fa[4].shape)
        K.glow_flow_stack_fwd(*fa[:4], w1f, *fa[5:], (3, 3), (1, 1), False)
    with pytest.raises(ValueError):
        K.glow_flow_stack_fwd(fa[0].cpu(), *fa[1:], (3, 3), (1, 1), False)


def test_glow_step_flow_stack_matches_kernel_free_reference(cuda):
    """A small f32 Glow (2 blocks of 3 flows, f = 64, 16x16, batch 4) with
    flow_stack=True: loss and every gradient with K6 agree with the same
    weights run with no kernel (5e-4 of each tensor's max |g| plus 1e-6 of
    the largest); one K6 launch of each direction per block, and the
    likelihood forward one no-save launch per block."""
    from vgd_tpu_torch.core import config as C
    from vgd_tpu_torch.train.glow import GlowTrainer
    cfg = C.GlowConfig(data=C.DataConfig(image_size=(16, 16), batch_size=4),
                       run=C.RunConfig(compute_dtype="float32"), n_flows=3,
                       n_blocks=2, filter_size=64, flow_stack=True)
    tr = GlowTrainer(cfg, (16, 16, 3), device="cuda")
    g = torch.Generator(device=cuda).manual_seed(14)
    tr.init(g)
    batch = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8,
                          device=cuda, generator=g)
    noise = torch.rand(4, 16, 16, 3, device=cuda, generator=g)
    K.LAUNCHES.clear()
    tr.init_step(batch, noise=noise)
    assert sum(K.LAUNCHES.values()) == 0
    with torch.no_grad():
        for blk in tr.model.blocks():
            for t in blk.flows.coupling.zero.parameters():
                t.copy_(0.01 * torch.randn(t.shape, device=cuda, generator=g))
    x = tr._prep(batch, None, noise)
    out = []
    for plain in (False, True):
        tr.model.zero_grad(set_to_none=True)
        K.LAUNCHES.clear()
        if plain:
            with K.plain_reference():
                lp, ld, _ = tr.model(x)
                (-(lp.mean() + ld)).backward()
            assert sum(K.LAUNCHES.values()) == 0
        else:
            lp, ld, _ = tr.model(x)
            (-(lp.mean() + ld)).backward()
            assert dict(K.LAUNCHES) == {"glow_flow_stack_fwd": 2,
                                        "glow_flow_stack_bwd": 2}
        out.append((float(lp.mean()), {n: p.grad.clone() for n, p in
                                       tr.model.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    gmax = max(float(v.abs().max()) for v in out[1][1].values())
    for name, ref in out[1][1].items():
        err = float((out[0][1][name] - ref).abs().max())
        assert err <= 5e-4 * float(ref.abs().max()) + 1e-6 * gmax, name
    K.LAUNCHES.clear()
    tr.forward(x)
    assert dict(K.LAUNCHES) == {"glow_flow_stack_fwd_nosave": 2}


K1_MAIN_AND_RAGGED = (
    [tuple(s[1:7]) for s in chip_smoke.K1_SHAPES]
    + [(2, 16, 16, 3, 32, 1), (2, 32, 32, 3, 32, 0), (3, 31, 29, 5, 7, 0),
       (2, 9, 13, 12, 20, 1)])


@pytest.mark.parametrize("b,h,w,cin,k,pad", K1_MAIN_AND_RAGGED)
def test_k1_plan_shapes_match_plain_and_are_bit_equal(cuda, b, h, w, cin, k,
                                                      pad):
    """K1 in bf16 at the VAE-GAN's nine shapes (256x256, B = 64: 128 x 32,
    128 x 64, 128 x 128 and 64 x 64 tiles, split and unsplit reductions,
    enc0's 3 channels padded to 4) and at ragged ones (Cin 3 at padding 1,
    Cin 5 and 12 gathered element by element): chip_smoke's K1 tolerances
    against the plain version, and c, mean and var bit-equal over two
    calls (fixed-order sums, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(b, h, w, cin, device=cuda, generator=g).bfloat16()
    wt = (torch.randn(k, cin, 4, 4, device=cuda, generator=g)
          * (2.0 / (16 * cin)) ** 0.5).bfloat16()
    c, mean, var = K.conv_stats(x, wt, pad)
    again = K.conv_stats(x, wt, pad)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip((c, mean, var), again))
    rc, rm, rv = K.conv_stats_plain(x, wt, pad)
    # the plan's scratch is what the C entry point writes under that plan
    plan = K.conv_stats_plan(b, h, w, cin, k, pad, sm_count=torch.cuda
                             .get_device_properties(cuda).multi_processor_count)
    assert _build.conv_bn_stats_lib().vgd_conv_stats_part_floats(
        b, h, w, plan.cin, k, pad, plan.tile, plan.splits) == plan.part_floats
    assert float((c - rc).abs().max()) <= \
        chip_smoke.K1_C_REL * float(rc.abs().max())
    for got, ref in ((mean, rm), (var, rv)):
        torch.testing.assert_close(got, ref, rtol=chip_smoke.K1_STAT_RTOL,
                                   atol=chip_smoke.K1_STAT_ATOL)


@pytest.mark.parametrize("with_lse", [False, True], ids=["K3", "K2fwd"])
@pytest.mark.parametrize("b,n,m,d", [
    (16, 16384, 64, 256), (16, 4096, 64, 256), (16, 1024, 1024, 256),
    (3, 1000, 70, 256), (2, 129, 33, 128)])
def test_flash_forward_sites_match_plain_and_are_bit_equal(cuda, b, n, m, d,
                                                           with_lse):
    """The flash forward (3xTF32 tensor cores) at the UNet's three
    attention sites and two ragged shapes, without lse (K3) and with it
    (K2's forward): o and lse within chip_smoke's ATTN_ATOL of the plain
    versions, and bit-equal over two calls."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(b, s, d, device=cuda, generator=g)
               for s in (n, m, m))
    scale = d ** -0.5
    if with_lse:
        got, again = (K.attention_fwd_lse(q, k, v, scale) for _ in range(2))
        ref = K.attention_fwd_lse_plain(q, k, v, scale)
    else:
        got, again = ((K.flash_attention(q, k, v, scale),) for _ in range(2))
        ref = (K.attention_plain(q, k, v, scale),)
    torch.cuda.synchronize()
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)
        assert float((a - r).abs().max()) <= chip_smoke.ATTN_ATOL
