"""Port UNet and weight bridge against the JAX UNet, on the CPU in f32.

The same JAX params (shaped by the Flax module, values from numpy so norms
and biases are not trivially 1 and 0) go through ``UNet(fused=True).apply`` and,
bridged, through the port's UNet. Tolerance atol 2e-4, as
tests/test_diffusion.py holds the JAX chains: f32 on both sides, different
summation orders in convs, norms and softmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.models import unet as J
from vgd_tpu_torch.io.jax_params import from_jax_params, load_jax_params
from vgd_tpu_torch.models import unet as P

ATOL = 2e-4


def jax_params(module, *inputs, seed=0):
    """A params tree shaped by ``module.init`` (traced, not run) and filled
    from numpy: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1^2),
    biases ~ N(0, 0.1^2), global tokens ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0),
                            *map(jnp.asarray, inputs))["params"]

    def fill(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "bias":
            z = 0.1 * z
        return z.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("attention", [True, False])
def test_unet_forward_matches_jax(attention):
    x = _nhwc(0, (2, 32, 32, 3))
    t = np.array([3, 7], np.int32)
    jm = J.UNet(out_ch=3, base_ch=8, time_emb_dim=32, attention=attention,
                fused=True)
    params = jax_params(jm, x, t, seed=1)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                            jnp.asarray(t))
    pm = P.UNet(in_ch=3, out_ch=3, base_ch=8, time_emb_dim=32,
                attention=attention, fused=True)
    load_jax_params(pm, params)
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("attention", [True, False])
def test_unfused_unet_forward_matches_jax(attention):
    """The training form (stock GroupNorm + SiLU, the stock add of the time
    projection, K2's plain form on the CPU) against the JAX UNet's XLA
    form on the same params."""
    x = _nhwc(10, (2, 32, 32, 3))
    t = np.array([2, 6], np.int32)
    jm = J.UNet(out_ch=3, base_ch=8, time_emb_dim=32, attention=attention,
                fused=False)
    params = jax_params(jm, x, t, seed=11)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                            jnp.asarray(t))
    pm = P.UNet(in_ch=3, out_ch=3, base_ch=8, time_emb_dim=32,
                attention=attention, fused=False)
    load_jax_params(pm, params)
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_conv_block_matches_jax():
    """Time projection after conv1 and before gn1; f32 residual add."""
    x = _nhwc(2, (2, 8, 8, 8))
    temb = _nhwc(3, (2, 32))
    jb = J.ConvBlock(16, 32, fused=True)
    params = jax_params(jb, x, temb, seed=4)
    ref = jb.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
    pb = P.ConvBlock(8, 16, 32, torch.float32, fused=True)
    load_jax_params(pb, params)
    with torch.no_grad():
        out = pb(torch.from_numpy(x), torch.from_numpy(temb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("in_ch", [8, 16], ids=["residual_conv", "identity"])
def test_fused_conv_block_bf16_is_bit_equal_to_explicit_casts(in_ch):
    """In bf16 with ``fused=True`` the block hands its unbiased bf16 conv
    outputs and the convs' biases to K4 with gn1's cast (``out_dtype``) and
    gn2's residual add and cast (``residual``): on the CPU that is bit for
    bit the block written with the explicit f32 casts and adds, each conv's
    bias added to its bf16 output in bf16 (what cuDNN's convolution and the
    stock ``add_`` of its bias compute on the card)."""
    from vgd_tpu_torch.ops.kernels import groupnorm_silu_plain
    g = torch.Generator().manual_seed(7)
    pb = P.ConvBlock(in_ch, 16, 32, torch.bfloat16, fused=True)
    with torch.no_grad():
        for prm in pb.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.3
                      + (1.0 if prm.ndim == 1 else 0.0) * 0.1)
    x = torch.randn(2, 8, 8, in_ch, generator=g).to(torch.bfloat16)
    temb = torch.randn(2, 32, generator=g)
    bf16 = torch.bfloat16

    def conv(c, x):
        return c.unbiased(x) + c.bias.to(bf16)
    with torch.no_grad():
        got = pb(x, temb)
        res = x if pb.residual_conv is None else conv(pb.residual_conv, x)
        h = conv(pb.conv1, x)
        h = h + pb.time_proj(temb)[:, None, None, :].to(h.dtype)
        h = groupnorm_silu_plain(h.float(), pb.gn1.weight, pb.gn1.bias,
                                 8).to(bf16)
        h = groupnorm_silu_plain(conv(pb.conv2, h).float(), pb.gn2.weight,
                                 pb.gn2.bias, 8)
        want = (h + res.float()).to(bf16)
    assert got.dtype == bf16
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_group_norm_silu_shift_is_one_function_in_both_forms(dtype):
    """``GroupNormSiLU(x, shift=s)``: K4's form (its plain version on the
    CPU) and the training form's stock add then norm agree bit for bit."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 4, 4, 16, generator=g).to(dtype)
    s = torch.randn(2, 16, generator=g)
    fused, train = P.GroupNormSiLU(16, fused=True), P.GroupNormSiLU(16)
    with torch.no_grad():
        for m in (fused, train):
            m.weight.copy_(1.0 + 0.1 * torch.arange(16.0))
            m.bias.fill_(0.2)
        for kw in ({}, {"out_dtype": torch.bfloat16}):
            got = fused(x, shift=s, **kw)
            assert got.dtype == kw.get("out_dtype", torch.float32)
            assert torch.equal(got, train(x, shift=s, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_group_norm_silu_biases_are_one_function_in_both_forms(dtype):
    """``GroupNormSiLU(x, conv_bias=b, shift=s)`` and ``(x, residual=r,
    conv_bias=b, residual_bias=rb)``: K4's form (its plain version on the
    CPU) and the training form's stock adds then norm agree bit for bit."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn(2, 4, 4, 16, generator=g).to(dtype)
    r = torch.randn(2, 4, 4, 16, generator=g).to(dtype)
    b, rb = torch.randn(16, generator=g), torch.randn(16, generator=g)
    s = torch.randn(2, 16, generator=g)
    fused, train = P.GroupNormSiLU(16, fused=True), P.GroupNormSiLU(16)
    with torch.no_grad():
        for m in (fused, train):
            m.weight.copy_(1.0 + 0.1 * torch.arange(16.0))
            m.bias.fill_(0.2)
        for kw in ({"conv_bias": b, "shift": s},
                   {"conv_bias": b, "residual": r},
                   {"conv_bias": b, "residual": r, "residual_bias": rb}):
            got = fused(x, out_dtype=dtype, **kw)
            assert got.dtype == dtype
            assert torch.equal(got, train(x, out_dtype=dtype, **kw))


def _parent_fused_block(self, x, t_emb):
    """The fused ConvBlock as it ran before K4 took the convs' biases: each
    conv biased (on the card cuDNN's convolution, then the stock ``add_`` of
    the bias cast to the conv's dtype), the time projection as gn1's
    shift."""
    def conv(c, x):
        return c.unbiased(x) + c.bias.to(c.dtype)
    res = x if self.residual_conv is None else conv(self.residual_conv, x)
    h = conv(self.conv1, x)
    h = self.gn1(h, out_dtype=self.dtype, shift=self.time_proj(t_emb))
    return self.gn2(conv(self.conv2, h), out_dtype=self.dtype, residual=res)


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_fused_unet_with_the_biases_in_k4_is_the_biased_conv_composition(
        dtype, attention, monkeypatch):
    """The fused UNet, each ConvBlock's conv biases handed to K4 (its plain
    version on the CPU), is bit for bit the same UNet whose blocks run the
    biased convs and stock bias adds first; and one forward hands K4 14
    conv biases and 6 residual-conv biases, the convs' own bias adds left
    to the attention block's qkv and proj and the output conv."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls.append((str(func), args))
            return func(*args, **(kwargs or {}))
    g = torch.Generator().manual_seed(15)
    pm = P.UNet(in_ch=3, out_ch=3, base_ch=8, time_emb_dim=32,
                attention=attention, dtype=dtype, fused=True)
    pm.init_parameters(g)
    with torch.no_grad():
        for name, prm in pm.named_parameters():
            if name.endswith("bias"):
                prm.copy_(0.5 * torch.randn(prm.shape, generator=g))
    x = torch.randn(2, 32, 32, 3, generator=g)
    t = torch.tensor([3, 700])
    with torch.no_grad(), Log() as log:
        got = pm(x, t)
    # the op's (x, conv_bias, residual_bias); the dispatcher drops trailing
    # Nones
    gns = [(a[0], *(a[i] if len(a) > i else None for i in (8, 9)))
           for name, a in log.calls if name == "vgd.groupnorm_silu.default"]
    assert len(gns) == 14
    assert sum(cb is not None for _, cb, _ in gns) == 14
    assert sum(rb is not None for _, _, rb in gns) == 6
    assert all(cb.dtype == torch.float32 and cb.shape == (h.shape[-1],)
               for h, cb, _ in gns)
    convs = [args for name, args in log.calls
             if name == "aten.convolution.default"]
    assert sum(a[2] is not None for a in convs) == (3 if attention else 1)
    monkeypatch.setattr(P.ConvBlock, "_fused", _parent_fused_block)
    with torch.no_grad():
        want = pm(x, t)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "training"])
def test_conv_block_hands_the_time_projection_to_k4_when_fused(fused):
    """The fused block passes the time projection (f32, (B, C)) to gn1's
    op as its shift and makes no stock broadcast add of it; the training
    form adds it with the stock op and passes no shift."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls.append((str(func), args))
            return func(*args, **(kwargs or {}))
    g = torch.Generator().manual_seed(12)
    pb = P.ConvBlock(8, 16, 32, torch.bfloat16, fused=fused)
    with torch.no_grad():
        for prm in pb.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.3)
    x = torch.randn(2, 8, 8, 8, generator=g).to(torch.bfloat16)
    temb = torch.randn(2, 32, generator=g)
    with torch.no_grad(), Log() as log:
        pb(x, temb)

    def shape(a):
        return tuple(a.shape) if isinstance(a, torch.Tensor) else None
    adds = [args for name, args in log.calls if name == "aten.add.Tensor"
            and [shape(a) for a in args[:2]] == [(2, 8, 8, 16), (2, 1, 1, 16)]]
    gns = [args for name, args in log.calls
           if name == "vgd.groupnorm_silu.default"]
    shifts = [args[7] for args in gns if len(args) > 7
              and args[7] is not None]
    if fused:
        assert len(gns) == 2 and not adds
        assert len(shifts) == 1
        assert shifts[0].dtype == torch.float32
        assert shifts[0].shape == (2, 16)
    else:
        assert not gns and not shifts and len(adds) == 1


def test_training_conv_block_bf16_is_bit_equal_to_explicit_casts():
    """With ``fused=False`` the block passes gn1's cast and gn2's residual
    add and cast through the same calls as the fused form, in stock ops
    under autograd: bit for bit the block written with the explicit f32
    casts and add, and its gradients reach every parameter."""
    from vgd_tpu_torch.ops.kernels import groupnorm_silu_plain
    g = torch.Generator().manual_seed(8)
    pb = P.ConvBlock(8, 16, 32, torch.bfloat16, fused=False)
    with torch.no_grad():
        for prm in pb.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.3)
    x = torch.randn(2, 8, 8, 8, generator=g).to(torch.bfloat16)
    temb = torch.randn(2, 32, generator=g)
    bf16 = torch.bfloat16
    got = pb(x, temb)
    got.float().square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in pb.parameters())
    with torch.no_grad():
        res = pb.residual_conv(x)
        h = pb.conv1(x)
        h = h + pb.time_proj(temb)[:, None, None, :].to(h.dtype)
        h = groupnorm_silu_plain(h.float(), pb.gn1.weight, pb.gn1.bias,
                                 8).to(bf16)
        h = groupnorm_silu_plain(pb.conv2(h).float(), pb.gn2.weight,
                                 pb.gn2.bias, 8)
        want = (h + res.float()).to(bf16)
    assert got.dtype == bf16
    assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("block", ["self", "cross"])
def test_attention_blocks_match_jax(block):
    """q | k | v channel split of the qkv conv, k | v split of to_kv,
    LayerNorm eps 1e-5 and the broadcast global tokens."""
    x = _nhwc(5, (2, 4, 4, 32))
    if block == "self":
        jb = J.AttentionBlock(32, fused=True)
        pb = P.AttentionBlock(32, torch.float32, fused=True)
    else:
        jb = J.CrossAttentionToGlobalTokens(32, fused=True)
        pb = P.CrossAttentionToGlobalTokens(32, torch.float32, fused=True)
    params = jax_params(jb, x, seed=6)
    ref = jb.apply({"params": params}, jnp.asarray(x))
    load_jax_params(pb, params)
    with torch.no_grad():
        out = pb(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_sinusoidal_embedding_matches_jax():
    """atol 1e-4: at t=999 the f32 angle has an ulp of 6e-5, and one ulp
    between the two frameworks' exp moves sin/cos by that much."""
    t = np.array([0, 1, 17, 999], np.int32)
    ref = J.sinusoidal_embedding(jnp.asarray(t), 256)
    out = P.sinusoidal_embedding(torch.from_numpy(t), 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_upsample_and_pool_match_jax(hw):
    """Bilinear x2 with half-pixel centres, edge rows and columns included
    (both clamp to the border pixel), and 2x2 max pooling."""
    x = _nhwc(7, (2,) + hw + (3,))
    up = P.upsample2_bilinear(torch.from_numpy(x)).numpy()
    ref = np.asarray(J.upsample2_bilinear(jnp.asarray(x)))
    np.testing.assert_allclose(up, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(up[:, 0], ref[:, 0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(up[:, :, -1], ref[:, :, -1], atol=1e-6, rtol=0)
    pool = P.max_pool2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(pool,
                                  np.asarray(J.max_pool2(jnp.asarray(x))))


def test_bridge_is_strict():
    x = np.zeros((1, 16, 16, 3), np.float32)
    t = np.zeros((1,), np.int32)
    params = jax_params(J.UNet(base_ch=8, time_emb_dim=32), x, t)
    pm = P.UNet(base_ch=8, time_emb_dim=32)
    sd = from_jax_params(params, pm)
    assert sd["down1.conv1.weight"].shape == (8, 3, 3, 3)      # OIHW
    assert sd["time_mlp1.weight"].shape == (128, 32)          # (out, in)
    assert sd["cross_attn2.global_tokens"].shape == (1, 64, 256)
    missing = {k: v for k, v in params.items() if k != "out_conv"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(missing, pm)
    extra = dict(params, attn3={"norm": {"scale": np.ones(32, np.float32)}})
    with pytest.raises(ValueError, match="unused"):
        from_jax_params(extra, pm)
    with pytest.raises(ValueError, match="unknown parameter"):
        from_jax_params({"down1": {"conv1": {"mean": np.zeros(3)}}})
    no_attn = P.UNet(base_ch=8, time_emb_dim=32, attention=False)
    with pytest.raises(ValueError, match="unused"):
        from_jax_params(params, no_attn)


def test_init_follows_flax_defaults():
    """Seeded init: truncated lecun-normal kernels (std 1/sqrt(fan_in),
    cut at 2 sigma of the underlying normal), zero biases, unit norms,
    normal(1) global tokens; same seed, same weights."""
    def make(seed):
        return P.UNet(base_ch=16, time_emb_dim=32).init_parameters(
            torch.Generator().manual_seed(seed))
    m = make(0)
    w = m.up3.conv1.weight.detach()
    fan_in = w.shape[1] * 9
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.8796 / fan_in ** 0.5 + 1e-6
    assert float(m.up3.conv1.bias.detach().abs().max()) == 0.0
    assert float((m.down2.gn1.weight.detach() - 1).abs().max()) == 0.0
    assert abs(float(m.cross_attn2.global_tokens.detach().std()) - 1) < 0.05
    m2 = make(0)
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
