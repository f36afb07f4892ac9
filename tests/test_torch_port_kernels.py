"""Port kernels, CPU side: the plain PyTorch versions of K2 (differentiable
flash attention: forward with logsumexp, backward), K3 (flash attention)
and K4 (GroupNorm+SiLU) against the JAX package's Pallas kernels run in
interpret mode, and the wrappers' CPU dispatch.

Tolerances are those of tests/test_kernels.py (rtol 1e-4, atol 1e-5): both
sides compute in f32 and differ only in summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.ops import pallas_kernels as JK
from vgd_tpu.ops.pallas_kernels import (attention_xla, flash_attention,
                                        groupnorm_silu, groupnorm_silu_xla)
from vgd_tpu_torch.ops import kernels as K

RTOL, ATOL = 1e-4, 1e-5


def _qkv(b, n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, d)).astype(np.float32),
            rng.standard_normal((b, m, d)).astype(np.float32),
            rng.standard_normal((b, m, d)).astype(np.float32))


@pytest.mark.parametrize("b,n,m,d,bq,bkv", [
    (2, 128, 128, 32, 64, 64),     # self-attention layout
    (2, 256, 64, 32, 128, 64),     # cross-attention: many queries, 64 keys
])
def test_attention_plain_matches_pallas_interpret(b, n, m, d, bq, bkv):
    q, k, v = _qkv(b, n, m, d)
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=bq, block_kv=bkv, force="pallas",
                          interpret=True)
    out = K.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_attention_plain_ragged_matches_xla():
    """Ragged N and M (the CUDA kernel masks them; the TPU wrapper falls
    back to XLA) with an explicit scale."""
    q, k, v = _qkv(2, 100, 70, 32, seed=1)
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3)
    out = K.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 16, 16, 16)])
def test_groupnorm_silu_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(2)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = groupnorm_silu(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), groups=8, force="pallas",
                         interpret=True)
    out = K.groupnorm_silu_plain(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), groups=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_groupnorm_silu_plain_two_pass_variance():
    """A common offset 100x the spread: the two-pass variance keeps the f32
    result within 2e-4 of a float64 reference (the one-pass E[x^2] - E[x]^2
    form loses about 3 digits here), and equals the JAX XLA form."""
    rng = np.random.default_rng(3)
    x = (10.0 + 0.1 * rng.standard_normal((1, 16, 16, 16))).astype(
        np.float32)
    one, zero = np.ones(16, np.float32), np.zeros(16, np.float32)
    xg = x.astype(np.float64).reshape(1, 16, 16, 8, 2)
    xn = ((xg - xg.mean(axis=(1, 2, 4), keepdims=True))
          / np.sqrt(xg.var(axis=(1, 2, 4), keepdims=True) + 1e-5))
    want = (xn / (1.0 + np.exp(-xn))).reshape(x.shape)
    out = K.groupnorm_silu_plain(torch.from_numpy(x), torch.from_numpy(one),
                                 torch.from_numpy(zero)).numpy()
    np.testing.assert_allclose(out, want, atol=2e-4)
    ref = groupnorm_silu_xla(jnp.asarray(x), jnp.asarray(one),
                             jnp.asarray(zero))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=1e-4)


def test_wrappers_on_cpu_use_plain_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 32))
    x = torch.randn(1, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    w, b = torch.ones(16), torch.zeros(16)
    K.LAUNCHES.clear()
    torch.testing.assert_close(K.flash_attention(q, k, v),
                               K.attention_plain(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(K.groupnorm_silu(x, w, b),
                               K.groupnorm_silu_plain(x, w, b), rtol=0, atol=0)
    assert sum(K.LAUNCHES.values()) == 0


def test_wrappers_raise_on_a_device_without_a_kernel():
    """A tensor neither on the CPU nor on CUDA (here: meta) is refused,
    never computed by the plain version."""
    q = torch.empty(1, 64, 32, device="meta")
    with pytest.raises(ValueError):
        K.flash_attention(q, q, q)
    x = torch.empty(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError):
        K.groupnorm_silu(x, torch.ones(16), torch.zeros(16))


# K2 at the tolerances of tests/test_kernels.py's VJP test: outputs rtol /
# atol 1e-5, gradients rtol 1e-4 / atol 1e-5 (f32, summation order only)
K2_SHAPES = [(2, 256, 256, 32, 128, 128),     # self-attention layout
             (2, 256, 64, 32, 128, 64)]       # cross-attention: 64 keys


def _k2_inputs(b, n, m, d, seed=4):
    q, k, v = _qkv(b, n, m, d, seed)
    do = np.random.default_rng(seed + 1).standard_normal((b, n, d)).astype(
        np.float32)
    return q, k, v, do, 1.0 / np.sqrt(d)


@pytest.mark.parametrize("b,n,m,d,bq,bkv", K2_SHAPES)
def test_attention_fwd_lse_plain_matches_pallas_interpret(b, n, m, d, bq, bkv):
    q, k, v, _, scale = _k2_inputs(b, n, m, d)
    o_ref, lse_ref = JK._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale, bq, bkv, True)
    o, lse = K.attention_fwd_lse_plain(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), scale)
    assert lse.shape == (b, n)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,m,d,bq,bkv", K2_SHAPES)
def test_attention_bwd_plain_matches_pallas_interpret(b, n, m, d, bq, bkv):
    """The FlashAttention-2 formulas on the saved (q, k, v, o, lse)."""
    q, k, v, do, scale = _k2_inputs(b, n, m, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o, lse = JK._flash_fwd_lse(jq, jk, jv, scale, bq, bkv, True)
    ref = JK._flash_diff_bwd(scale, bq, bkv, True, (jq, jk, jv, o, lse),
                             jnp.asarray(do))
    out = K.attention_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(lse)[..., 0]), torch.from_numpy(do),
        scale)
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,n,m,d,bq,bkv", K2_SHAPES)
def test_attention_grads_match_jax_pallas_interpret(monkeypatch, b, n, m, d,
                                                   bq, bkv):
    """The port's autograd.Function (plain versions on the CPU) against
    jax.grad through the custom-VJP Pallas kernels, loss sum(sin(o)); both
    sides past their size gate (JAX: force="pallas")."""
    monkeypatch.setattr(K, "MIN_FLASH_ELEMS", 0)
    q, k, v, _, _ = _k2_inputs(b, n, m, d)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(JK.attention(q, k, v, block_q=bq,
                                            block_kv=bkv, force="pallas",
                                            interpret=True)))
    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    torch.sin(K.attention(tq, tk, tv)).sum().backward()
    for name, a, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_attention_grad_reaches_expanded_keys(monkeypatch):
    """k/v expanded over the batch (the cross-attention's global tokens):
    autograd sums dk/dv over the batch, equal to differentiating the plain
    full-matrix attention (the autograd.Function, past the size gate)."""
    monkeypatch.setattr(K, "MIN_FLASH_ELEMS", 0)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((3, 40, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 8, 32)).astype(np.float32))
    grads = []
    for fn in (K.attention, K.attention_plain):
        src = kv.clone().requires_grad_()
        k, v = src.split(16, dim=-1)
        k = k.expand(3, -1, -1).contiguous()
        v = v.expand(3, -1, -1).contiguous()
        torch.cos(fn(q, k, v, 0.25)).sum().backward()
        grads.append(src.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-5)


def test_k2_cpu_dispatch_and_plain_reference(monkeypatch):
    """On the CPU the autograd.Function (past the size gate) runs the plain
    versions and counts no launch; inside plain_reference() ``attention``
    is the plain full-matrix form, and the context restores itself."""
    monkeypatch.setattr(K, "MIN_FLASH_ELEMS", 0)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 64, 32, 32))
    K.LAUNCHES.clear()
    out = K.attention(q, k, v)
    assert out.grad_fn is not None and "Attention" in type(out.grad_fn).__name__
    out.sum().backward()
    assert sum(K.LAUNCHES.values()) == 0
    with K.plain_reference():
        ref = K.attention(q, k, v)
        assert "Attention" not in type(ref.grad_fn).__name__
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    assert not K._PLAIN_REFERENCE
    x = torch.empty(1, 8, 32, device="meta")
    with pytest.raises(ValueError):
        K.attention_fwd_lse(x, x, x, 1.0)


@pytest.mark.parametrize("n,m,kernel", [
    (4096, 64, False),      # cross_attn3 at 256x256: 2^18
    (16384, 64, True),      # cross_attn2: 2^20
    (1024, 1024, True),     # the bottleneck: 2^20
    (1023, 1024, False)])
def test_attention_size_gate_follows_the_reference(n, m, kernel):
    """``attention`` sends N * M below the JAX package's MIN_FLASH_ELEMS to
    the plain full-matrix form (no autograd.Function, no launch) and
    everything else to K2, as ``vgd_tpu``'s ``attention`` does."""
    assert K.MIN_FLASH_ELEMS == JK.MIN_FLASH_ELEMS
    q = torch.zeros(1, n, 8, requires_grad=True)
    kv = torch.zeros(1, m, 8)
    out = K.attention(q, kv, kv)
    assert ("Attention" in type(out.grad_fn).__name__) == kernel


@pytest.mark.parametrize("b,n,m,want", [
    (16, 16384, 64, (16, 1024)),     # cross_attn2 at 256x256: 16 key blocks
    (16, 4096, 64, (16, 256)),       # cross_attn3
    (16, 1024, 1024, (1, 1024)),     # bottleneck: 256 key blocks, no split
    (3, 1000, 70, (32, 32))])        # ragged: 6 key blocks
def test_dkv_splits_cover_the_rows(b, n, m, want):
    splits, rows = K.dkv_splits(b, n, m, 132)
    assert (splits, rows) == want
    assert rows % 16 == 0 and splits * rows >= n > (splits - 1) * rows


def _tf32_split(x):
    """(hi, lo) of f32 x as the K2 backward kernels split it: hi = x rounded
    to TF32 (10 mantissa bits, to nearest, ties away from zero: cvt.rna),
    lo = x - hi (exact) truncated to TF32."""
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _tf32_mm(a, b, passes):
    """a @ b as the kernels' tensor cores compute it: three TF32 products
    (hi hi + hi lo + lo hi; lo lo dropped) accumulated in f32, or with
    passes=1 the single TF32 product."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    return ah @ bh if passes == 1 else ah @ bh + (ah @ bl + al @ bh)


@pytest.mark.parametrize("b,n,m", [(2, 256, 64), (1, 300, 130),
                                   (2, 129, 33)])
def test_k2_backward_three_tf32_passes_meet_the_chip_tolerance(b, n, m):
    """The K2 backward kernels run every product as three TF32 tensor-core
    products. Emulated on the CPU at D = 256, dq, dk and dv come within
    chip_smoke's K2_GRAD_REL x max |.| of the f32 plain versions, and a
    single TF32 pass does not: the three passes are what the tolerance
    needs."""
    from chip_smoke import K2_GRAD_REL
    d = 256
    rng = np.random.default_rng(b * n + m)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, d))
                                    .astype(np.float32)) for s in (n, m, m, n))
    scale = d ** -0.5
    o, lse = K.attention_fwd_lse_plain(q, k, v, scale)
    delta = (do * o).sum(-1)
    ref = (K.attention_dq_plain(q, k, v, do, lse, delta, scale),
           *K.attention_dkv_plain(q, k, v, do, lse, delta, scale))
    for passes in (3, 1):
        s_ = _tf32_mm(q, k.transpose(1, 2), passes) * scale
        p = torch.exp(s_ - lse[..., None])
        ds = p * (_tf32_mm(do, v.transpose(1, 2), passes)
                  - delta[..., None]) * scale
        got = (_tf32_mm(ds, k, passes),
               _tf32_mm(ds.transpose(1, 2), q, passes),
               _tf32_mm(p.transpose(1, 2), do, passes))
        rel = [float((a - r).abs().max() / r.abs().max())
               for a, r in zip(got, ref)]
        if passes == 3:
            assert max(rel) <= K2_GRAD_REL, rel
        else:
            assert max(rel) > K2_GRAD_REL, rel


@pytest.mark.parametrize("b,n,m", [(2, 256, 64), (1, 300, 130),
                                   (2, 129, 33), (2, 128, 1024)])
def test_flash_forward_three_tf32_passes_meet_the_chip_tolerance(b, n, m):
    """The flash forward (K2 fwd, K3) runs S = q k^T and P V as three TF32
    tensor-core products each. Emulated on the CPU at D = 256, o and lse
    come within chip_smoke's ATTN_ATOL of ``attention_fwd_lse_plain``, and
    a single TF32 pass does not: the three passes are what the tolerance
    needs."""
    from chip_smoke import ATTN_ATOL
    d = 256
    rng = np.random.default_rng(b * n + m + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, d))
                                .astype(np.float32)) for s in (n, m, m))
    scale = d ** -0.5
    ro, rlse = K.attention_fwd_lse_plain(q, k, v, scale)
    for passes in (3, 1):
        s_ = _tf32_mm(q, k.transpose(1, 2), passes) * scale
        lse = torch.logsumexp(s_, dim=-1)
        o = _tf32_mm(torch.exp(s_ - lse[..., None]), v, passes)
        err = max(float((o - ro).abs().max()),
                  float((lse - rlse).abs().max()))
        if passes == 3:
            assert err <= ATTN_ATOL, err
        else:
            assert err > ATTN_ATOL, err
