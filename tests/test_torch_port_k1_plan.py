"""K1's plan (``kernels.conv_stats_plan``) and its arithmetic, on the CPU.

The plan picks K1's tile, its reduction splits and its scratch size for a
shape; the C entry point of ``csrc/conv_bn_stats.cu`` checks and runs it.
These tests hold the plan to what the kernel needs (whole 64-deep stages,
every one in exactly one split, at least about one wave of resident blocks
on an H100's 132 SMs at the VAE-GAN's shapes, the scratch the kernel
writes), and emulate the kernel's arithmetic (bf16 operands, f32 products
summed over the plan's splits in their fixed order, per-tile two-pass
statistics over two row halves, Chan's combine in the combine kernel's
order) against the plain version within chip_smoke's unchanged K1
tolerances."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (K1_C_REL, K1_EXTRA, K1_SHAPES, K1_STAT_ATOL,
                        K1_STAT_RTOL)
from vgd_tpu_torch.ops import kernels as K

SMS = 132
STAGE = 64
COMBINE_THREADS = 256


def _plan(shape, dtype="bfloat16"):
    b, h, w, cin, k, pad = shape
    return K.conv_stats_plan(b, h, w, cin, k, pad, bf16=dtype == "bfloat16",
                             sm_count=SMS)


def _m(shape):
    b, h, w, _, _, pad = shape
    return b * ((h + 2 * pad - 4) // 2 + 1) * ((w + 2 * pad - 4) // 2 + 1)


ALL = ([(s[0], tuple(s[1:7]), "bfloat16") for s in K1_SHAPES]
       + [(s[0], tuple(s[1:7]), s[7]) for s in K1_EXTRA])


@pytest.mark.parametrize("site,shape", [(s[0], tuple(s[1:7]))
                                        for s in K1_SHAPES])
def test_plan_fills_the_card_at_the_main_path_shapes(site, shape):
    """About one wave at least: a block on nine tenths of the SMs or more;
    a split only where the output tiles leave more than half the SMs idle,
    and then no more blocks than one wave of resident blocks holds."""
    plan = _plan(shape)
    tiles = plan.m_tiles * plan.n_tiles
    blocks = tiles * plan.splits
    resident = SMS * {1: 5, 2: 3, 3: 2}[plan.tile]
    assert blocks >= 0.9 * SMS, (site, plan)
    if 2 * tiles >= SMS:
        assert plan.splits == 1, (site, plan)
    else:
        assert plan.splits > 1 and blocks <= resident, (site, plan)


@pytest.mark.parametrize("site,shape,dtype", ALL)
def test_plan_splits_cover_the_depth_once(site, shape, dtype):
    """Every 64-deep stage of the reduction lies in exactly one split, no
    split is empty, and the tiles cover M and K."""
    plan = _plan(shape, dtype)
    _, _, _, cin, k, _ = shape
    m = _m(shape)
    assert plan.m_tiles * plan.bm >= m > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= k > (plan.n_tiles - 1) * plan.bn
    if dtype == "float32":
        assert (plan.tile, plan.splits, plan.cin) == (0, 1, cin)
        return
    depth = 16 * plan.cin
    assert plan.k_split % STAGE == 0 and plan.k_split >= STAGE
    stages = [s for z in range(plan.splits)
              for s in range(z * plan.k_split,
                             min(depth, (z + 1) * plan.k_split), STAGE)]
    assert stages == list(range(0, depth, STAGE))
    assert all(z * plan.k_split < depth for z in range(plan.splits))


@pytest.mark.parametrize("site,shape,dtype", ALL)
def test_plan_scratch_is_what_the_kernel_writes(site, shape, dtype):
    """part holds the per-tile (mean, M2) of every channel (2 K mtiles
    floats) and, with splits, each split's partial M x K tile from the next
    128-byte boundary (the epilogues store float4s): the highest float the
    kernels write is the plan's last."""
    plan = _plan(shape, dtype)
    k = shape[4]
    m = _m(shape)
    # the statistics partials: (K + n) * tiles + mi, + 1, over tiles of
    # the product's rows, or of the split sum's 16-row pieces
    rows = plan.bm if plan.splits == 1 else 16
    assert plan.stat_rows == rows
    top = 2 * k * -(-m // rows)
    if plan.splits > 1:
        offset = (top + 31) // 32 * 32
        assert offset % 32 == 0 and offset >= top
        top = offset + plan.splits * m * k
    assert plan.part_floats == top


@pytest.mark.parametrize("shape,cin,run", [
    ((64, 256, 256, 3, 32, 0), 4, 8),    # enc0: padded to two taps a run
    ((2, 16, 16, 3, 32, 1), 3, 1),       # padding 1: odd window starts
    ((3, 31, 29, 5, 7, 0), 5, 1),        # ragged
    ((2, 9, 13, 12, 20, 1), 12, 1),      # ragged
    ((2, 16, 16, 8, 32, 1), 8, 8),
    ((64, 127, 127, 32, 64, 0), 32, 8)])
def test_plan_gathers(shape, cin, run):
    """16-byte runs of A only where they are aligned: Cin % 8 == 0, or 1-3
    channels padded to 4 with padding 0 and an even width; the rest element
    by element."""
    plan = _plan(shape)
    assert (plan.cin, plan.run) == (cin, run)


def _tile_stats(c, bm):
    """Per bm-row tile, each channel's (mean, M2) as the kernel's epilogue
    takes them: two row halves summed in order, their sums added, then the
    same for the squared deviations (f32)."""
    out = []
    for m0 in range(0, c.shape[0], bm):
        t = c[m0:m0 + bm]
        halves = [t[:bm // 2], t[bm // 2:]]
        s = [h.sum(0) if len(h) else torch.zeros(c.shape[1]) for h in halves]
        mean = (s[0] + s[1]) / len(t)
        q = [((h - mean) ** 2).sum(0) if len(h) else torch.zeros(c.shape[1])
             for h in halves]
        out.append((float(len(t)), mean, q[0] + q[1]))
    return out


def _chan(a, b):
    """chan_merge of the combine kernel: (n, mean, M2) of a joined with b."""
    na, ma, m2a = a
    nb, mb, m2b = b
    if nb == 0.0:
        return a
    n = np.float32(na + nb)
    fb = np.float32(nb / n)
    delta = (mb - ma).numpy().astype(np.float64)
    mean = torch.from_numpy((delta * fb + ma.numpy()).astype(np.float32))
    m2 = m2a + m2b + torch.from_numpy(
        (delta * delta).astype(np.float32)) * np.float32(na) * fb
    return (float(n), mean, m2)


def _combine(tiles, k):
    """combine_stats_kernel: thread t merges tiles t, t + 256, ... in
    order, then a tree over the threads."""
    zero = (0.0, torch.zeros(k), torch.zeros(k))
    slots = [zero] * COMBINE_THREADS
    for i, t in enumerate(tiles):
        slots[i % COMBINE_THREADS] = _chan(slots[i % COMBINE_THREADS], t)
    s = COMBINE_THREADS // 2
    while s:
        slots = [_chan(slots[i], slots[i + s]) for i in range(s)] + slots[s:]
        s //= 2
    n, mean, m2 = slots[0]
    return mean, torch.clamp(m2 / n, min=0.0)


def test_k1_arithmetic_emulated_at_dis5_meets_the_chip_tolerance():
    """dis5 (64 x 8 x 8 x 256 -> 512, padding 1) as K1 computes it: bf16
    operands, the products of each of the plan's splits in f32, the splits
    summed in split order, per-tile two-pass statistics and Chan's combine
    in the kernel's order, within chip_smoke's K1 tolerances of
    ``conv_stats_plain``."""
    b, h, w, cin, k, pad = 64, 8, 8, 256, 512, 1
    plan = _plan((b, h, w, cin, k, pad))
    assert plan.splits > 1 and plan.stat_rows == 16
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin))
                         .astype(np.float32)).bfloat16()
    wt = torch.from_numpy((rng.standard_normal((k, cin, 4, 4))
                           * (2.0 / (16 * cin)) ** 0.5).astype(np.float32)
                          ).bfloat16()
    rc, rm, rv = K.conv_stats_plain(x, wt, pad)
    # A (M, 16 Cin) with depth (ky, kx, ci), B (16 Cin, K), upcast exactly
    cols = F.unfold(x.float().permute(0, 3, 1, 2), 4, padding=pad, stride=2)
    a = cols.reshape(b, cin, 16, -1).permute(0, 3, 2, 1).reshape(-1, 16 * cin)
    bmat = wt.float().permute(2, 3, 1, 0).reshape(16 * cin, k)
    c = torch.zeros(a.shape[0], k)
    for z in range(plan.splits):
        d = slice(z * plan.k_split, (z + 1) * plan.k_split)
        c = c + a[:, d] @ bmat[d]
    mean, var = _combine(_tile_stats(c, plan.stat_rows), k)
    assert float((c - rc.reshape(-1, k)).abs().max()) <= \
        K1_C_REL * float(rc.abs().max())
    torch.testing.assert_close(mean, rm, rtol=K1_STAT_RTOL, atol=K1_STAT_ATOL)
    torch.testing.assert_close(var, rv, rtol=K1_STAT_RTOL, atol=K1_STAT_ATOL)
