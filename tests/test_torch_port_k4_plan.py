"""K4's plan (``kernels.groupnorm_silu_plan``) and its arithmetic, on the CPU.

The plan spreads each image over CTAs as contiguous runs of whole pixels,
packs images into waves and sizes the shared memory; the C entry point of
``csrc/groupnorm_silu.cu`` checks and runs it. These tests hold the plan to
what the kernel needs (every pixel in exactly one run and one tile, the
shared memory within an SM's share, no more CTAs than can be resident, the
main path's shapes resident and an image the grid cannot hold streamed),
and emulate the kernel's arithmetic (per-run two-pass statistics, Chan's
combine of a run's tiles, the merge of an image's runs in their fixed
order with the counts the kernel derives from the plan) against the plain
version within chip_smoke's unchanged K4 tolerance."""
import numpy as np
import pytest
import torch

from chip_smoke import GN_ATOL, GN_EXTRA, GN_SHAPES
from vgd_tpu_torch.ops import kernels as K

SMS = 132
MAIN = [tuple(s[:4]) for s in GN_SHAPES]
ALL = MAIN + GN_EXTRA
DTYPES = [torch.float32, torch.bfloat16]
IDS = [f"{'x'.join(map(str, s))}" for s in ALL]


def _share(per_sm):
    """Dynamic shared memory a CTA may have at per_sm CTAs an SM."""
    return min(K.K4_SMEM_BYTES, K.K4_SM_SMEM // per_sm - K.K4_BLOCK_RESERVED)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ALL, ids=IDS)
def test_every_pixel_is_in_exactly_one_run_and_tile(shape, dtype):
    b, h, w, c = shape
    plan = K.groupnorm_silu_plan(b, h, w, c, 8, dtype, SMS)
    hw = h * w
    covered = np.zeros(hw, np.int64)
    for j in range(plan.cpi):
        lo, hi = j * plan.run_pix, min((j + 1) * plan.run_pix, hw)
        assert lo < hi, (j, plan)            # no CTA without pixels
        tiles = -(-(hi - lo) // plan.tile_pix)
        assert tiles <= plan.tiles
        for t in range(tiles):
            covered[lo + t * plan.tile_pix:
                    min(lo + (t + 1) * plan.tile_pix, hi)] += 1
    assert (covered == 1).all()
    # every image in exactly one wave slot: images slot, slot + ipw, ...
    images = sorted(s + k * plan.ipw for s in range(plan.ipw)
                    for k in range(plan.waves) if s + k * plan.ipw < b)
    assert images == list(range(b))
    assert (plan.waves - 1) * plan.ipw < b <= plan.waves * plan.ipw


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ALL, ids=IDS)
def test_shared_memory_and_grid_fit_the_card(shape, dtype):
    """The buffer holds a tile; buffer plus the kernel's other shared memory
    fits a CTA's share at per_sm CTAs an SM; the grid is no larger than the
    CTAs that can be resident; the threads own whole 8-channel vectors."""
    b, h, w, c = shape
    plan = K.groupnorm_silu_plan(b, h, w, c, 8, dtype, SMS)
    es = torch.empty((), dtype=dtype).element_size()
    assert plan.per_sm == 2
    assert plan.buf_bytes % 128 == 0
    assert plan.tile_pix * c * es <= plan.buf_bytes
    assert plan.smem == plan.buf_bytes + K.K4_AUX_BYTES
    assert plan.smem <= _share(plan.per_sm)
    assert plan.grid == plan.cpi * plan.ipw <= SMS * plan.per_sm
    assert plan.cpi <= 512              # the merge's loads a lane
    assert plan.threads % (c // 8) == 0 and plan.threads <= 256
    assert plan.threads >= 128          # whole warps merge the groups
    assert plan.refill == (plan.mode == "resident" and plan.waves > 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MAIN, ids=IDS[:len(MAIN)])
def test_main_path_shapes_are_resident(shape, dtype):
    """At the UNet's shapes a run stays in shared memory between its
    statistics and its apply pass (x read once), and a wave fills at least
    nine tenths of the resident CTAs."""
    plan = K.groupnorm_silu_plan(*shape, 8, dtype, SMS)
    assert plan.mode == "resident" and plan.tiles == 1
    assert plan.tile_pix == plan.run_pix
    assert plan.grid >= 0.9 * SMS * plan.per_sm


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_an_image_above_the_grids_shared_memory_is_streamed(dtype):
    b, h, w, c = 2, 512, 512, 64
    es = torch.empty((), dtype=dtype).element_size()
    plan = K.groupnorm_silu_plan(b, h, w, c, 8, dtype, SMS)
    assert h * w * c * es > SMS * plan.per_sm * _share(plan.per_sm)
    assert plan.mode == "streamed" and plan.tiles > 1 and plan.ipw == 1
    assert plan.waves == b and not plan.refill
    assert plan.tile_pix * plan.tiles >= plan.run_pix


@pytest.mark.parametrize("sms", [114, 132])
def test_plan_follows_the_sm_count(sms):
    """Another card's SM count (an H100 PCIe has 114) gives a plan that
    fits it."""
    for shape in MAIN:
        for dtype in DTYPES:
            plan = K.groupnorm_silu_plan(*shape, 8, dtype, sms)
            assert plan.grid <= sms * plan.per_sm
            assert plan.mode == "resident"


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        K.groupnorm_silu_plan(2, 4, 4, 12, 4)
    with pytest.raises(ValueError, match="multiple of"):
        K.groupnorm_silu_plan(2, 4, 4, 24, 16)
    with pytest.raises(ValueError, match="groups"):
        K.groupnorm_silu_plan(2, 4, 4, 64, 64)


def _emulate(x, scale, bias, groups, eps, plan, residual=None,
             out_dtype=None):
    """The kernel's arithmetic in f32 (torch): for every run of every image,
    each tile's group mean and centred sum of squares (two passes), the
    tiles combined in order (Chan); the image's runs merged in run order
    with the counts the kernel derives (run_pix * cg, the last run the
    rest); then normalise, affine, SiLU, the residual, the cast."""
    b, h, w, c = x.shape
    cg, hw = c // groups, h * w
    xs = x.float().reshape(b, hw, groups, cg)
    y = torch.empty(b, hw, groups, cg)
    for img in range(b):
        parts = []
        for j in range(plan.cpi):
            lo, hi = j * plan.run_pix, min((j + 1) * plan.run_pix, hw)
            n = mean = m2 = None
            for t0 in range(lo, hi, plan.tile_pix):
                tile = xs[img, t0:min(t0 + plan.tile_pix, hi)]
                cnt = float(tile.shape[0] * cg)
                tm = tile.sum(dim=(0, 2)) / cnt
                t2 = ((tile - tm[None, :, None]) ** 2).sum(dim=(0, 2))
                if n is None:
                    n, mean, m2 = cnt, tm, t2
                else:
                    nn, d = n + cnt, tm - mean
                    mean = mean + d * (cnt / nn)
                    m2 = m2 + t2 + d * d * (n * cnt / nn)
                    n = nn
            parts.append((mean, m2))
        last = hw - (plan.cpi - 1) * plan.run_pix
        nj = torch.tensor([plan.run_pix] * (plan.cpi - 1) + [last],
                          dtype=torch.float32) * cg
        means = torch.stack([p[0] for p in parts])       # (cpi, G)
        m2s = torch.stack([p[1] for p in parts])
        ntot = float(hw * cg)
        mean = (nj[:, None] * means).sum(0) / ntot
        m2 = (m2s + nj[:, None] * (means - mean) ** 2).sum(0)
        rstd = torch.rsqrt(m2 / ntot + eps)
        y[img] = (xs[img] - mean[None, :, None]) * rstd[None, :, None]
    y = y.reshape(b, h, w, c) * scale + bias
    y = y * torch.sigmoid(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype if out_dtype is None else out_dtype)


# (shape, smem_bytes): the main path's plans in miniature, ragged shapes,
# and small shared memory, which forces runs of several tiles (streamed)
EMULATED = [((2, 8, 8, 32), K.K4_SMEM_BYTES), ((3, 7, 9, 24), K.K4_SMEM_BYTES),
            ((1, 1, 1, 8), K.K4_SMEM_BYTES),
            ((2, 64, 64, 32), K.K4_AUX_BYTES + 128 * 12),
            ((3, 40, 40, 24), K.K4_AUX_BYTES + 128 * 4)]


@pytest.mark.parametrize("form", ["f32", "gn2"])
@pytest.mark.parametrize("shape,smem", EMULATED,
                         ids=[f"{'x'.join(map(str, s))}-{m}"
                              for s, m in EMULATED])
def test_kernel_arithmetic_matches_plain(shape, smem, form):
    """Within chip_smoke's GN_ATOL in f32; bf16 (gn2: bf16 in, residual and
    out) within one bf16 ulp of |y| plus GN_ATOL."""
    g = torch.Generator().manual_seed(11)
    b, h, w, c = shape
    x = torch.randn(*shape, generator=g) * 2.0 + 0.5
    scale = 1.0 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    kw = {}
    if form == "gn2":
        x = x.to(torch.bfloat16)
        kw = {"out_dtype": torch.bfloat16,
              "residual": torch.randn(*shape, generator=g).to(torch.bfloat16)}
    plan = K.groupnorm_silu_plan(b, h, w, c, 8, x.dtype, 16, smem)
    if smem < K.K4_SMEM_BYTES:
        assert plan.mode == "streamed" and plan.tiles > 1
    got = _emulate(x, scale, bias, 8, 1e-5, plan, **kw).float()
    ref = K.groupnorm_silu_plain(x, scale, bias, 8, **kw).float()
    tol = torch.full_like(ref, GN_ATOL)
    if form == "gn2":
        _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
        tol = tol + torch.ldexp(torch.ones_like(ref), e - 8)
    assert ((got - ref).abs() <= tol).all(), float((got - ref).abs().max())


def test_kernel_arithmetic_keeps_two_pass_accuracy():
    """A common offset 100x the spread, runs of several tiles: the merged
    statistics keep the result within 2e-4 of float64, as the plain
    version's two-pass variance does."""
    rng = np.random.default_rng(3)
    x = (10.0 + 0.1 * rng.standard_normal((1, 16, 16, 16))).astype(
        np.float32)
    xg = x.astype(np.float64).reshape(1, 256, 8, 2)
    xn = ((xg - xg.mean(axis=(1, 3), keepdims=True))
          / np.sqrt(xg.var(axis=(1, 3), keepdims=True) + 1e-5))
    want = (xn / (1.0 + np.exp(-xn))).reshape(x.shape)
    plan = K.groupnorm_silu_plan(1, 16, 16, 16, 8, torch.float32, 8,
                                 K.K4_AUX_BYTES + 128 * 2)
    assert plan.mode == "streamed" and plan.cpi > 1
    got = _emulate(torch.from_numpy(x), torch.ones(16), torch.zeros(16), 8,
                   1e-5, plan).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
