"""K5's plain versions (the port's fused Glow coupling network on the CPU)
against the JAX package's ``glow_coupling_nn`` in interpret mode.

* forward at the four block shapes of the reference Glow (f = 64, batch 4)
  in bf16 at the JAX test's tolerance (rtol 2e-2, atol 2e-3: the two sides
  sum the bf16 products in other orders, and an h1 or h2 that rounds the
  other way moves the output by one bf16 ulp of its term) and in f32 at
  1e-5, and at a ragged size (7 x 5, 5 channels);
* the VJP (``torch.autograd.Function``) against JAX's custom VJP in f32, at
  the JAX test's 2e-3 x (1e-3 + max |g|) per gradient;
* the three plain functions one by one against the pieces of JAX's
  kernels: the output, h1 of ``_recompute_fwd``, and the gradients that
  ``_bwd_pallas`` returns from its two kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.ops import glow_coupling as JGC
from vgd_tpu_torch.ops import glow_coupling as PGC
from vgd_tpu_torch.ops import kernels as K

# (channels after the squeeze, spatial size) of K=32 L=4 at 64x64
BLOCK_SHAPES = [(12, 32), (24, 16), (48, 8), (96, 4)]
KHW, PAD = (3, 3), (1, 1)
BF16_TOL = dict(rtol=2e-2, atol=2e-3)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _params(rng, cin, f):
    """Coupling weights as numpy (HWIO), with a non-zero ZeroConv (a trained
    state: at init it is zero and the test would read 0 == 0)."""
    return {"conv1": {"w": rng.standard_normal((3, 3, cin, f)) * 0.05,
                      "b": rng.standard_normal(f) * 0.05},
            "conv2": {"w": rng.standard_normal((1, 1, f, f)) * 0.05,
                      "b": rng.standard_normal(f) * 0.05},
            "zero": {"w": rng.standard_normal((3, 3, f, cin)) * 0.01,
                     "b": np.full(cin, 0.02), "scale": np.full(cin, 0.1)}}


def _as(tree, fn):
    return {k: _as(v, fn) if isinstance(v, dict) else
            fn(np.asarray(v, np.float32)) for k, v in tree.items()}


def _port(p, ya, cd, grad=False):
    pt = _as(p, lambda a: torch.from_numpy(a).requires_grad_(grad))
    yt = torch.from_numpy(ya).requires_grad_(grad)
    return pt, yt, PGC.glow_coupling_nn(pt, yt, KHW, PAD, cd)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("ch,size", BLOCK_SHAPES + [(10, (7, 5))])
def test_forward_matches_jax(ch, size, dtype):
    rng = np.random.default_rng(ch)
    h, w = (size, size) if isinstance(size, int) else size
    p = _params(rng, ch // 2, 64)
    ya = rng.standard_normal((4, h, w, ch // 2)).astype(np.float32)
    want = JGC.glow_coupling_nn(_as(p, jnp.asarray), jnp.asarray(ya), KHW,
                                PAD, compute_dtype=jnp.dtype(dtype),
                                interpret=True)
    before = sum(K.LAUNCHES.values())
    _, _, got = _port(p, ya, getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(BF16_TOL if dtype == "bfloat16"
                                  else F32_TOL))
    assert sum(K.LAUNCHES.values()) == before      # the CPU launches nothing


def test_vjp_matches_jax_custom_vjp():
    """Every gradient (ya, w1, b1, w2, b2, wz, bz, scale) of sum(NN(ya) * g)
    in f32, against ``jax.grad`` through JAX's custom VJP."""
    rng = np.random.default_rng(3)
    p = _params(rng, 6, 32)
    ya = rng.standard_normal((2, 8, 9, 6)).astype(np.float32)
    g = rng.standard_normal((2, 8, 9, 6)).astype(np.float32)

    def loss(pp, yy):
        return jnp.sum(JGC.glow_coupling_nn(pp, yy, KHW, PAD, jnp.float32,
                                            interpret=True) * g)
    gp, gya = jax.grad(loss, argnums=(0, 1))(_as(p, jnp.asarray),
                                             jnp.asarray(ya))
    pt, yt, out = _port(p, ya, torch.float32, grad=True)
    (out * torch.from_numpy(g)).sum().backward()
    pairs = [("ya", np.asarray(gya), yt.grad)] + [
        (f"{a}.{b}", np.asarray(gp[a][b]), pt[a][b].grad)
        for a in gp for b in gp[a]]
    assert len(pairs) == 8          # ya and the seven weight leaves
    for name, want, got in pairs:
        tol = 2e-3 * (1e-3 + np.abs(want).max())
        assert np.abs(got.numpy() - want).max() <= tol, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_functions_match_jax_kernel_pieces(dtype):
    """fwd/bwd1/bwd2 plain on the packed operands against JAX: the output,
    h1 of ``_recompute_fwd``, and the eight gradients of ``_bwd_pallas``
    (dwz, dbz, db2, dscale from its first kernel; dya, dw1, db1, dw2 from
    its second), f32 at 1e-5 of max |.|, bf16 at 2e-2 of max |.|."""
    rng = np.random.default_rng(4)
    cin, f, b, h, w = 6, 32, 2, 8, 7
    p = _params(rng, cin, f)
    ya = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    g = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    jcd, cd = jnp.dtype(dtype), getattr(torch, dtype)
    jp = _as(p, jnp.asarray)
    ya_p = jnp.pad(jnp.asarray(ya), ((0, 0), (1, 1), (1, 1), (0, 0))
                   ).astype(jcd)
    w1 = jp["conv1"]["w"]
    wz = jp["zero"]["w"]
    w1f = w1.reshape(-1, f).astype(jcd)
    w1r = w1.transpose(3, 0, 1, 2).reshape(f, -1).astype(jcd)
    wzr = wz.transpose(2, 0, 1, 3).reshape(f, -1).astype(jcd)
    wzf = wz[::-1, ::-1].transpose(0, 1, 3, 2).reshape(-1, f).astype(jcd)
    w2 = jp["conv2"]["w"].reshape(f, f).astype(jcd)
    b1, b2 = jp["conv1"]["b"], jp["conv2"]["b"]
    bz, sc = jp["zero"]["b"], jp["zero"]["scale"]
    jh1, _ = JGC._recompute_fwd(ya_p, w1f, b1, w2, b2, b * h * w, jcd,
                                (h, w), KHW, PAD)
    jgrads = JGC._bwd_pallas(ya_p, w1f, w1r, b1, w2, b2, wzr, wzf, bz, sc,
                             jnp.asarray(g), (h, w), KHW, PAD, jcd, True)
    want = dict(zip(("dya", "dw1", "db1", "dw2", "db2", "dwz", "dbz",
                     "dscale"), (np.asarray(a, np.float32) for a in jgrads)))

    pt = _as(p, torch.from_numpy)
    pk = PGC.prep(torch.from_numpy(ya), pt["conv1"]["w"], pt["conv2"]["w"],
                  pt["zero"]["w"], cd)
    args = (pk["ya"], pk["w1f"], pt["conv1"]["b"], pk["w2"],
            pt["conv2"]["b"], pk["wz"])
    rel = 1e-5 if dtype == "float32" else 2e-2

    def close(got, ref, name):
        got = got.float().numpy().reshape(ref.shape)
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max() + 1e-7, \
            name

    out = K.glow_coupling_fwd(*args, pt["zero"]["b"], pt["zero"]["scale"],
                              KHW, PAD)
    h1, dh2, dwz, dbz, db2, dsc = K.glow_coupling_bwd1(
        *args, pk["wzf"], pt["zero"]["b"], pt["zero"]["scale"],
        torch.from_numpy(g), KHW, PAD)
    close(out, np.asarray(JGC.glow_coupling_nn(jp, jnp.asarray(ya), KHW, PAD,
                                               jcd, interpret=True)), "out")
    close(h1, np.asarray(jh1, np.float32), "h1")
    # dwz is (f, taps * cout), JAX's packed layout
    for name, got in (("dwz", dwz), ("dbz", dbz), ("db2", db2),
                      ("dscale", dsc)):
        close(got, want[name], name)
    assert dwz.shape == (f, 9 * cin) and dh2.dtype == cd
    dya, dw1, db1, dw2 = K.glow_coupling_bwd2(pk["ya"], pk["w1t"], pk["w2t"],
                                              h1, dh2, KHW, PAD)
    for name, got in (("dya", dya), ("dw1", dw1), ("db1", db1),
                      ("dw2", dw2)):
        close(got, want[name], name)


# (b, h, w, cout, f): ragged sizes whose corner pixels take five value-1
# border taps and edge pixels three (one row or column takes six)
NPACK_SHAPES = [(2, 7, 5, 5, 40), (1, 3, 4, 6, 16), (2, 1, 6, 3, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cout,f", NPACK_SHAPES)
def test_zeroconv_npack_matches_jax(b, h, w, cout, f, dtype):
    """The plain ZeroConv (``_coupling_convz``, the N-pack form K5 runs: r =
    h2 @ Wzr on the interior, ones @ Wzr for the value-1 border, shifted
    slice-adds) against JAX's ``_zeroconv_fwd`` / ``_shift_sum`` and against
    the direct conv of h2 padded with the value 1, at 1e-5 of max |.| (sums
    of the same exact products in other orders)."""
    rng = np.random.default_rng(b * 100 + h * 10 + w)
    jcd, cd = jnp.dtype(dtype), getattr(torch, dtype)
    h2 = np.maximum(rng.standard_normal((b * h * w, f)), 0.0)
    wz = rng.standard_normal((3, 3, f, cout)) * 0.1
    bz = rng.standard_normal(cout) * 0.1
    h2j = jnp.asarray(h2, jnp.float32).astype(jcd)
    wzr = jnp.asarray(wz, jnp.float32).transpose(2, 0, 1, 3).reshape(
        f, -1).astype(jcd)
    want, _ = JGC._zeroconv_fwd(h2j, wzr, jnp.asarray(bz, jnp.float32), b,
                                (h, w), KHW, PAD, cout, jcd)
    h2t = torch.from_numpy(h2).float().to(cd)
    wzt = torch.from_numpy(wz).float().reshape(9 * f, cout).to(cd)
    bzt = torch.from_numpy(bz).float()
    got = K._coupling_convz(h2t, wzt, bzt, (b, h, w), KHW, PAD)
    direct = K._mm(K._im2col(K._pad_hw(h2t.reshape(b, h, w, f), 1, 1, 1.0),
                             h, w, 3, 3), wzt) + bzt
    want = np.asarray(want, np.float32)
    tol = 1e-5 * np.abs(want).max()
    assert got.shape == (b * h * w, cout) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= tol
    assert np.abs(direct.numpy() - want).max() <= tol
