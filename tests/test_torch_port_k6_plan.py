"""K6's plan (``kernels.flow_stack_plan``) on the CPU, at the four block
shapes of the reference Glow and at chip_smoke.py's extra K6 shapes (f32,
two ragged ones with odd channel counts, the EEG variant's (3, 1) kernel):
each product's tile and the constraints it must keep, reductions split
into whole stages that cover the depth exactly, the scratch as the sum of
its pieces (recomputed here from the shapes), and the grid syncs per flow.
The C entry points check the same plan on the card
(``tests/test_torch_port_gpu.py``)."""
import pytest

import chip_smoke
from vgd_tpu_torch.ops import kernels as K

# (site, B, H, W, c, f, flows, kernel, bf16)
SHAPES = ([(s[0], *s[1:7], (3, 3), True) for s in chip_smoke.K6_SHAPES]
          + [(s[0], *s[1:8], s[8] == "bfloat16") for s in chip_smoke.K6_EXTRA])
IDS = [f"{s[0]}-{s[4]}" for s in SHAPES]
SPLITTABLE = {"zconv", "dwz", "dw2", "dw1", "dya"}


def _plan(site, b, h, w, c, f, n, khw, bf16):
    return K.flow_stack_plan(b, h, w, c, f, khw, bf16=bf16)


def _gemm_shapes(b, h, w, c, f, khw):
    """(M, N, K) of each bf16 product of one flow."""
    kh, kw = khw
    ch, taps = c // 2, kh * kw
    gc = -(-ch // 8) * 8
    p, q = b * h * w, b * (h + 2 * (kh // 2)) * (w + 2 * (kw // 2))
    return {"conv1": (p, f, taps * ch), "conv2": (p, f, f),
            "zconv": (p + 1, taps * ch, f), "dwz": (f, taps * gc, q),
            "dh2": (p, f, taps * gc), "dw2": (f, f, p), "dh1": (p, f, f),
            "dw1": (taps * ch, f, p), "dya": (p, taps * ch, f)}


def test_the_shapes_cover_every_gather_width():
    """The block shapes and the extras take all three gathers of ya's
    channels: 4-byte runs (ch 6, 12, 22), 16-byte runs (ch 24, 48) and the
    element path (the odd ch 5 and 11)."""
    runs = {s[4] // 2: _plan(*s).ya_run for s in SHAPES if s[-1]}
    assert runs == {6: 2, 12: 2, 24: 8, 48: 8, 5: 1, 11: 1, 22: 2}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_each_product_takes_a_tile_it_can_run(shape):
    """bf16: every product on one of its tensor-core tiles (wgmma 128x64
    for the narrow N-packs and dWz, 128x128 for the rest; mma.sync 64x64
    only for the forward's conv1, conv2 and ZeroConv, at the small blocks),
    f a multiple of 8 (every f-wide operand in 16-byte runs), the tile grid
    covering the output; f32: the 64x64 check tile."""
    plan = _plan(*shape)
    _, b, h, w, c, f, n, khw, bf16 = shape
    assert [p.name for p in plan.products] == [
        name for name, _, _ in K.K6_PRODUCTS]
    if not bf16:
        assert {p.tile for p in plan.products} == {"f32"}
        return
    assert f % 8 == 0
    shapes = _gemm_shapes(b, h, w, c, f, khw)
    for p in plan.products:
        bm, bn, kind = K.K6_TILES[p.tile]
        assert kind >= 0, p
        assert p.tile in dict((n, t) for n, t, _ in K.K6_PRODUCTS)[p.name], p
        assert p.tile.startswith("wgmma") or p.name in ("conv1", "conv2",
                                                        "zconv"), p
        assert (p.m, p.n, p.k) == shapes[p.name], p
        assert p.m_tiles == -(-p.m // bm) and p.n_tiles == -(-p.n // bn), p


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_splits_cover_the_reduction_in_whole_stages(shape):
    """Each product's splits are whole 64-deep stages (32-deep chunks on
    the f32 path) that cover its depth exactly: the last split is not
    empty; conv1, conv2, dh2 and dh1 are never split (their consumers read
    them through cp.async)."""
    plan = _plan(*shape)
    depth = 64 if plan.bf16 else 32
    for p in plan.products:
        assert p.splits >= 1 and p.k_split % depth == 0, p
        assert (p.splits - 1) * p.k_split < p.k <= p.splits * p.k_split, p
        if plan.bf16 and p.name not in SPLITTABLE:
            assert p.splits == 1, p
    ints = plan.ints()
    assert len(ints) == 3 * len(K.K6_PRODUCTS) + 1
    assert ints[-1] == plan.tail_pixels


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scratch_is_the_sum_of_its_pieces(shape):
    """The scratch of each direction is the sum of its pieces, each rounded
    up to 256 bytes, and the pieces are those the kernels use (recomputed
    here from the shapes: bf16 doubles ya and h1 in the backward)."""
    plan = _plan(*shape)
    _, b, h, w, c, f, n, khw, bf16 = shape
    p, ch, taps = b * h * w, c // 2, khw[0] * khw[1]
    pr = {x.name: x for x in plan.products}
    for backward in (False, True):
        pieces = dict(plan.bwd_pieces if backward else plan.fwd_pieces)
        assert plan.scratch_bytes(backward) == sum(pieces.values())
        assert all(v % 256 == 0 for v in pieces.values())
        if not bf16:
            continue
        up = lambda x: -(-x // 256) * 256  # noqa: E731
        dbl = 2 if backward else 1
        assert pieces["ya"] == up(dbl * p * ch * 2)
        assert pieces["h1"] == up(dbl * p * f * 2)
        z = pr["zconv"]
        assert pieces["r"] == up(4 * z.splits * (p + 1) * taps * ch)
        if backward:
            units = -(-p // plan.tail_pixels)
            assert pieces["ptail"] == up(4 * units * (c * c + 2 * c))
            assert pieces["pw2"] == up(4 * pr["dw2"].splits * f * f)
        else:
            assert pieces["cur"] == up(4 * p * c)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_grid_syncs_per_flow(shape):
    """bf16: 4 grid syncs per flow forward and 4 backward (flow k's
    gradient beside flow k - 1's recompute), at most 4 and 8, so a
    32-flow block stays within 129 and 257; f32 keeps the first design's
    5 and 10. The per-pixel unit fills about a unit an SM and fits its
    shared-memory arrays."""
    plan = _plan(*shape)
    _, b, h, w, c, f, n, khw, bf16 = shape
    fwd, bwd = plan.syncs(32)
    if bf16:
        assert plan.syncs_per_flow == (4, 4)
        assert fwd <= 129 and bwd <= 257
        assert plan.tail_pixels * c <= 2048
        assert plan.units == -(-b * h * w // plan.tail_pixels)
    else:
        assert plan.syncs_per_flow == (5, 10) and (fwd, bwd) == (160, 321)
    assert plan.syncs(n) == tuple(n * a + k for a, k in zip(
        plan.syncs_per_flow, plan.syncs_fixed))
