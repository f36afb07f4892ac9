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
        K.flash_attention_cuda(strided, q, q, 0.0625)
    with pytest.raises(ValueError):
        K.flash_attention(q, q.cpu(), q)


# K4: chip_smoke's main-path shapes (B=16, 256x256 UNet), smaller ones,
# ragged ones, and one an image of which the grid cannot hold (streamed);
# each in its three forms (f32; gn1: bf16 in and out; gn2: bf16 in, bf16
# residual, bf16 out)
K4_SHAPES = ([tuple(s[:4]) for s in chip_smoke.GN_SHAPES]
             + [(2, 64, 64, 64), (2, 32, 32, 256), (3, 7, 9, 24), (1, 1, 1, 8),
                (2, 512, 512, 64)])


def k4_call(cuda, shape, form, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, device=cuda, generator=g) * 3.0 + 1.0
    scale = torch.randn(c, device=cuda, generator=g)
    bias = torch.randn(c, device=cuda, generator=g)
    res = torch.randn(*shape, device=cuda, generator=g)
    xi, kw = chip_smoke.gn_form_args(form, x, res)
    return xi, scale, bias, kw


@pytest.mark.parametrize("form", ["f32", "gn1", "gn2"])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_groupnorm_silu_matches_plain(cuda, shape, form):
    """f32 within chip_smoke's GN_ATOL; a bf16 result within one bf16 ulp
    of |y| plus GN_ATOL (chip_smoke.gn_error)."""
    xi, scale, bias, kw = k4_call(cuda, shape, form)
    out = K.groupnorm_silu(xi, scale, bias, **kw)
    torch.cuda.synchronize()
    ref = K.groupnorm_silu_plain(xi, scale, bias, **kw)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    err, ratio = chip_smoke.gn_error(out, ref, form)
    assert ratio <= 1.0, (err, ratio)
    if shape == (2, 512, 512, 64):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert K.groupnorm_silu_plan(*shape, 8, xi.dtype, sms).mode == \
            "streamed"


@pytest.mark.parametrize("form", ["f32", "gn2"])
@pytest.mark.parametrize("shape", [(16, 256, 256, 64), (16, 32, 32, 256),
                                   (3, 7, 9, 24), (2, 512, 512, 64)])
def test_groupnorm_silu_is_bit_deterministic_with_one_launch(cuda, shape,
                                                             form):
    xi, scale, bias, kw = k4_call(cuda, shape, form, seed=2)
    before = K.LAUNCHES["groupnorm_silu"]
    a = K.groupnorm_silu(xi, scale, bias, **kw)
    assert K.LAUNCHES["groupnorm_silu"] == before + 1
    b = K.groupnorm_silu(xi, scale, bias, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["groupnorm_silu"] == before + 2
    assert torch.equal(a, b)


def test_groupnorm_silu_refuses_what_it_cannot_take(cuda):
    x = torch.randn(2, 8, 8, 64, device=cuda)
    one, zero = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.groupnorm_silu(x.half(), one, zero)
    with pytest.raises(ValueError, match="contiguous"):
        K.groupnorm_silu_cuda(x.transpose(1, 2), one, zero)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.groupnorm_silu(torch.randn(2, 8, 8, 12, device=cuda),
                         torch.ones(12, device=cuda),
                         torch.zeros(12, device=cuda), groups=4)
    with pytest.raises(ValueError, match="residual"):
        K.groupnorm_silu(x, one, zero, residual=x[:1])
    with pytest.raises(ValueError):
        K.groupnorm_silu(x, one, zero, residual=x.cpu())
    with pytest.raises(ValueError, match="out_dtype"):
        K.groupnorm_silu(x, one, zero, out_dtype=torch.float16)


def test_groupnorm_silu_refuses_a_shift_it_cannot_take(cuda):
    x = torch.randn(2, 8, 8, 64, device=cuda)
    one, zero = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    shift = torch.randn(2, 64, device=cuda)
    with pytest.raises(ValueError, match="shift must have shape"):
        K.groupnorm_silu(x, one, zero, shift=shift[:1])
    with pytest.raises(ValueError, match="float32"):
        K.groupnorm_silu(x, one, zero, shift=shift.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        K.groupnorm_silu_cuda(x, one, zero,
                              shift=torch.randn(64, 2, device=cuda).t())
    with pytest.raises(ValueError, match="without a residual"):
        K.groupnorm_silu(x, one, zero, residual=x, shift=shift)
    with pytest.raises(ValueError):
        K.groupnorm_silu(x, one, zero, shift=shift.cpu())


def test_groupnorm_silu_refuses_a_bias_it_cannot_take(cuda):
    """A conv or residual bias of the wrong shape, dtype, layout or device,
    or outside the fused ConvBlock's forms (gn1: with the shift; gn2: with a
    residual of x's dtype or f32, the residual bias with a residual of x's
    dtype), out_dtype x's, is refused before any launch."""
    x = torch.randn(2, 8, 8, 64, device=cuda).bfloat16()
    res = torch.randn(2, 8, 8, 64, device=cuda).bfloat16()
    one, zero = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    b = torch.randn(64, device=cuda)
    shift = torch.randn(2, 64, device=cuda)
    gn1 = {"out_dtype": torch.bfloat16, "shift": shift}
    gn2 = {"out_dtype": torch.bfloat16, "residual": res, "conv_bias": b}
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="conv_bias must have shape"):
        K.groupnorm_silu(x, one, zero, conv_bias=b[:32], **gn1)
    with pytest.raises(ValueError, match="conv_bias must be float32"):
        K.groupnorm_silu(x, one, zero, conv_bias=b.bfloat16(), **gn1)
    with pytest.raises(ValueError, match="conv_bias must be contiguous"):
        K.groupnorm_silu_cuda(x, one, zero, conv_bias=torch.randn(
            128, device=cuda)[::2], **gn1)
    with pytest.raises(ValueError):
        K.groupnorm_silu(x, one, zero, conv_bias=b.cpu(), **gn1)
    with pytest.raises(ValueError, match="fused ConvBlock's forms"):
        K.groupnorm_silu(x, one, zero, conv_bias=b,
                         out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fused ConvBlock's forms"):
        K.groupnorm_silu(x, one, zero, conv_bias=b, residual=res,
                         out_dtype=torch.float32)
    with pytest.raises(ValueError, match="fused ConvBlock's forms"):
        K.groupnorm_silu(x.float(), one, zero, conv_bias=b, residual=res,
                         out_dtype=torch.float32)
    with pytest.raises(ValueError, match="residual_bias must have shape"):
        K.groupnorm_silu(x, one, zero, residual_bias=b[:8], **gn2)
    with pytest.raises(ValueError, match="residual_bias must be float32"):
        K.groupnorm_silu(x, one, zero, residual_bias=b.bfloat16(), **gn2)
    with pytest.raises(ValueError):
        K.groupnorm_silu(x, one, zero, residual_bias=b.cpu(), **gn2)
    with pytest.raises(ValueError, match="residual bias only"):
        K.groupnorm_silu(x, one, zero, residual=res, residual_bias=b,
                         out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="residual bias only"):
        K.groupnorm_silu(x, one, zero, **{**gn2, "residual": res.float()},
                         residual_bias=b)
    with pytest.raises(ValueError, match="residual bias only"):
        K.groupnorm_silu(x, one, zero, conv_bias=b, residual_bias=b, **gn1)
    torch.cuda.synchronize()
    assert dict(K.LAUNCHES) == before


def k4_forced_plans(shape, dtype, sms):
    """K4's plans for one shape, each mode forced: "resident" (the buffer
    loaded at each wave's start, no refill), "refill" (at least two waves,
    the next wave's run loaded during the apply pass) and "streamed" (each
    run through a buffer of half its size, in tiles)."""
    b, h, w, c = shape
    pix = c * torch.empty((), dtype=dtype).element_size()

    def buf(pixels):
        return -(-pixels * pix // 128) * 128

    def run(ipw):
        return -(-h * w // min(2 * sms // ipw, 512))
    default = K.groupnorm_silu_plan(b, h, w, c, 8, dtype, sms)
    refill = K.groupnorm_silu_plan(
        b, h, w, c, 8, dtype, sms,
        smem_bytes=K.K4_AUX_BYTES + buf(run(max(1, b // 4))))
    streamed = K.groupnorm_silu_plan(
        b, h, w, c, 8, dtype, sms,
        smem_bytes=K.K4_AUX_BYTES + max(buf(1), buf(run(1)) // 256 * 128))
    plans = {"resident": default._replace(refill=False), "refill": refill,
             "streamed": streamed}
    assert plans["resident"].mode == refill.mode == "resident"
    assert refill.refill and refill.waves > 1
    assert streamed.mode == "streamed" and streamed.tiles > 1
    return plans


# the fused UNet's gn1 shapes at B=16 (256x256, base 64): chip_smoke's K4
# shapes, down1 and up1 sharing the first
K4_GN1_SHAPES = [tuple(s[:4]) for s in chip_smoke.GN_SHAPES]


@pytest.mark.parametrize("mode", ["resident", "refill", "streamed"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", K4_GN1_SHAPES)
def test_groupnorm_silu_shift_equals_k4_on_the_added_input(cuda, shape,
                                                            dtype, mode):
    """K4 with the time projection as its shift is bit for bit K4 on x with
    the shift added by the stock op the fused UNet ran before
    (``x + shift.to(x.dtype)``), under each plan mode, and counts one
    launch with a shift."""
    g = torch.Generator(device=cuda).manual_seed(6)
    b, c = shape[0], shape[-1]
    x = (torch.randn(*shape, device=cuda, generator=g) * 3.0 + 1.0).to(dtype)
    scale = torch.randn(c, device=cuda, generator=g)
    bias = torch.randn(c, device=cuda, generator=g)
    shift = 4.0 * torch.randn(b, c, device=cuda, generator=g)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = k4_forced_plans(shape, dtype, sms)[mode]
    kw = {"out_dtype": torch.bfloat16, "plan": plan}
    before = K.LAUNCHES.copy()
    got = K.groupnorm_silu(x, scale, bias, shift=shift, **kw)
    want = K.groupnorm_silu(x + shift[:, None, None, :].to(dtype), scale,
                            bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES - before == {"groupnorm_silu": 2,
                                   "groupnorm_silu_shift": 1}


def test_groupnorm_silu_shift_in_a_graph_replay(cuda):
    """K4 with a shift captured in a CUDA graph: each replay reads the
    shift's buffer as it stands then and equals the eager shifted call,
    which equals K4 on the input with the shift added."""
    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (16, 64, 64, 128)
    x = torch.randn(*shape, device=cuda, generator=g).bfloat16()
    scale = torch.randn(128, device=cuda, generator=g)
    bias = torch.randn(128, device=cuda, generator=g)
    shift = torch.randn(16, 128, device=cuda, generator=g)
    kw = {"out_dtype": torch.bfloat16}
    st = torch.cuda.Stream(cuda)
    with torch.cuda.stream(st):
        K.groupnorm_silu(x, scale, bias, shift=shift, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=st):
        out = K.groupnorm_silu(x, scale, bias, shift=shift, **kw)
    for step in range(3):
        shift.copy_(torch.randn(16, 128, device=cuda, generator=g) * step)
        graph.replay()
        torch.cuda.synchronize()
        eager = K.groupnorm_silu(x, scale, bias, shift=shift, **kw)
        added = K.groupnorm_silu(x + shift[:, None, None, :].bfloat16(),
                                 scale, bias, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, eager) and torch.equal(eager, added)


# the fused ConvBlock's forms with the convs' biases, by x's dtype: gn1
# (conv1's bias and the time projection as the shift), gn2 (conv2's bias)
# with a residual of x's dtype, for bf16 x also with an f32 residual (the
# bottleneck's with attention), and gn2 with a 1x1 residual conv's output of
# x's dtype and that conv's bias
K4_BIASED_FORMS = [
    pytest.param(dtype, form, id=f"{name}-{form}")
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
    for form in ("gn1", "gn2", "gn2_f32_residual", "gn2_residual_bias")
    if not (dtype == torch.float32 and form == "gn2_f32_residual")]


@pytest.mark.parametrize("dtype,form", K4_BIASED_FORMS)
@pytest.mark.parametrize("mode", ["resident", "refill", "streamed"])
@pytest.mark.parametrize("shape", K4_GN1_SHAPES)
def test_groupnorm_silu_biases_equal_k4_on_the_added_inputs(cuda, shape,
                                                             dtype, mode,
                                                             form):
    """K4 with the convs' biases is bit for bit K4 on the inputs that the
    stock ops the fused UNet ran before added in their order (``x +
    conv_bias.to(x.dtype)``, then ``+ shift.to(x.dtype)``; ``residual +
    residual_bias.to(residual.dtype)``), under each plan mode, and counts
    one launch with each operand it took."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b, c = shape[0], shape[-1]
    x = (torch.randn(*shape, device=cuda, generator=g) * 3.0 + 1.0).to(dtype)
    scale = torch.randn(c, device=cuda, generator=g)
    bias = torch.randn(c, device=cuda, generator=g)
    conv_bias = 2.0 * torch.randn(c, device=cuda, generator=g)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = k4_forced_plans(shape, dtype, sms)[mode]
    kw = {"out_dtype": dtype, "plan": plan}
    xa = x + conv_bias.to(dtype)
    want_launches = {"groupnorm_silu": 2, "groupnorm_silu_bias": 1}
    if form == "gn1":
        shift = 4.0 * torch.randn(b, c, device=cuda, generator=g)
        added = {"shift": shift}
        plain = {"x": xa + shift[:, None, None, :].to(dtype)}
        want_launches["groupnorm_silu_shift"] = 1
    else:
        rdtype = torch.float32 if form == "gn2_f32_residual" else dtype
        res = torch.randn(*shape, device=cuda, generator=g).to(rdtype)
        added, plain = {"residual": res}, {"x": xa, "residual": res}
        if form == "gn2_residual_bias":
            rb = 2.0 * torch.randn(c, device=cuda, generator=g)
            added["residual_bias"] = rb
            plain["residual"] = res + rb.to(rdtype)
            want_launches["groupnorm_silu_residual_bias"] = 1
    before = K.LAUNCHES.copy()
    got = K.groupnorm_silu(x, scale, bias, conv_bias=conv_bias, **added,
                           **kw)
    want = K.groupnorm_silu(plain.pop("x"), scale, bias, **plain, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert K.LAUNCHES - before == want_launches


def test_groupnorm_silu_refuses_a_grid_the_occupancy_does_not_allow(cuda):
    """Four CTAs an SM do not fit (that needs at most 64 registers a
    thread): the cooperative launch is refused with an error, never shrunk.
    One and two CTAs an SM run and agree with the plain version. The C entry
    point's shared-memory layout is the plan's."""
    xi, scale, bias, kw = k4_call(cuda, (16, 128, 128, 64), "f32")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = K.groupnorm_silu_plan(16, 128, 128, 64, 8, xi.dtype, sms,
                                 per_sm=4)
    assert plan.grid > 3 * sms
    with pytest.raises(RuntimeError, match="launch failed"):
        K.groupnorm_silu(xi, scale, bias, plan=plan)
    assert _build.groupnorm_silu_lib().vgd_groupnorm_silu_aux_bytes() == \
        K.K4_AUX_BYTES
    for per_sm in (1, 2):
        plan = K.groupnorm_silu_plan(16, 128, 128, 64, 8, xi.dtype, sms,
                                     per_sm=per_sm)
        torch.testing.assert_close(
            K.groupnorm_silu(xi, scale, bias, plan=plan),
            K.groupnorm_silu_plain(xi, scale, bias), atol=1e-4, rtol=0)


def test_groupnorm_silu_sync_probe_counts_no_launch_and_leaves_k4_right(cuda):
    """K4's exchange probe runs on K4's barrier words, counts no kernel
    launch, and leaves them ready for K4."""
    before = dict(K.LAUNCHES)
    for cpi, ipw in ((44, 3), (8, 16), (16, 8)):
        for rounds in (0, 1, 64):
            K.groupnorm_silu_sync_probe(rounds, cpi, ipw, cuda)
    torch.cuda.synchronize()
    assert dict(K.LAUNCHES) == before
    xi, scale, bias, kw = k4_call(cuda, (16, 32, 32, 256), "gn2", seed=4)
    err, ratio = chip_smoke.gn_error(
        K.groupnorm_silu(xi, scale, bias, **kw),
        K.groupnorm_silu_plain(xi, scale, bias, **kw), "gn2")
    assert ratio <= 1.0, err


# small grids, so that two launches can be resident at once: two images of
# 7 x 9 pixels are 126 CTAs of one pixel each
K4_CONCURRENT = (2, 7, 9, 24)


def k4_inputs(cuda, n, seed):
    """Operands of ``n`` gn2-form K4 calls at K4_CONCURRENT, made and
    synchronized before any is launched."""
    ops = [k4_call(cuda, K4_CONCURRENT, "gn2", seed=seed + i)
           for i in range(n)]
    torch.cuda.synchronize()
    return ops


def k4_launch(streams, ops):
    """K4 on each operand set of ``ops``, the streams taken in turns, with
    nothing between the launches; returns the (unsynchronized) outputs."""
    outs = []
    for i, (xi, scale, bias, kw) in enumerate(ops):
        with torch.cuda.stream(streams[i % len(streams)]):
            outs.append(K.groupnorm_silu(xi, scale, bias, **kw))
    return outs


def k4_check(outs, ops):
    torch.cuda.synchronize()
    for out, (xi, scale, bias, kw) in zip(outs, ops):
        err, ratio = chip_smoke.gn_error(
            out, K.groupnorm_silu_plain(xi, scale, bias, **kw), "gn2")
        assert ratio <= 1.0, err


def test_groupnorm_silu_on_two_streams_at_once_matches_plain(cuda):
    """Launches on two streams that may overlap use barrier words of their
    own (one buffer per device and stream), so each stays right."""
    a, b = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    words = []
    for st in (a, b):
        with torch.cuda.stream(st):
            words.append(K._k4_sync(torch.device(cuda)).data_ptr())
    assert words[0] != words[1]
    ops = k4_inputs(cuda, 80, 100)
    k4_check(k4_launch((a, b), ops), ops)


def test_groupnorm_silu_graph_replays_beside_eager_calls(cuda):
    """A CUDA graph of K4 calls, captured on a stream that has barrier
    words and on one that has none yet (each captured call then zeroes
    words of its own), replays on the default stream while eager K4 calls
    run on another; every result matches the plain version."""
    dev = torch.device(cuda)
    xi, scale, bias, kw = k4_call(cuda, K4_CONCURRENT, "gn2", seed=5)
    ref = K.groupnorm_silu_plain(xi, scale, bias, **kw)
    warm, fresh, eager = (torch.cuda.Stream(cuda) for _ in range(3))
    with torch.cuda.stream(warm):
        K.groupnorm_silu(xi, scale, bias, **kw)
    torch.cuda.synchronize()
    K._K4_SYNC.pop((dev, fresh.cuda_stream), None)
    for st in (warm, fresh):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=st):
            outs = [K.groupnorm_silu(xi, scale, bias, **kw)
                    for _ in range(4)]
        assert (dev, fresh.cuda_stream) not in K._K4_SYNC
        ops = k4_inputs(cuda, 20, 200)
        eager_outs = []
        for k in range(10):     # a replay, then two eager calls beside it
            graph.replay()
            eager_outs += k4_launch((eager,), ops[2 * k:2 * k + 2])
        k4_check(eager_outs, ops)
        for out in outs:
            err, ratio = chip_smoke.gn_error(out, ref, "gn2")
            assert ratio <= 1.0, err


def test_step_graph_replay_spans_and_capture_counters(cuda, monkeypatch):
    """Under the profiler each replay of a ``StepGraph`` is one
    ``vgd.graph.replay`` span; its one capture is counted, with its host
    seconds and the memory its private pool reserved, and its replays'
    least host seconds are kept, traced or not."""
    from types import SimpleNamespace
    from torch.profiler import ProfilerActivity, profile
    from vgd_tpu_torch.train import common
    from vgd_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "COUNTERS", type(trace.COUNTERS)())
    owner = SimpleNamespace(device=torch.device(cuda), step=0)
    w = torch.linspace(0.5, 1.5, 64 * 64, device=cuda).reshape(64, 64)

    def step(batch):
        owner.step += 1
        return {"s": torch.tanh(batch.float() @ w).sum()}
    g = common.StepGraph(step, owner)
    chunk = torch.randint(0, 256, (12, 4, 64), dtype=torch.uint8,
                          device=cuda)
    first = common.WARMUP_STEPS + 1          # the eager steps, one replay
    g.run(chunk[:first])
    torch.cuda.synchronize()
    assert trace.COUNTERS["graph.replay_min_s"] > 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.run(chunk[first:])
        torch.cuda.synchronize()
    host = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    assert host.count("vgd.graph.replay") == len(chunk) - first
    assert "vgd.graph.capture" not in host
    assert trace.COUNTERS["graph.captures"] == 1
    assert trace.COUNTERS["graph.capture_s"] > 0
    assert trace.COUNTERS["graph.capture_reserved_bytes"] >= 0
    assert owner.step == len(chunk)
    want = sum(float(torch.tanh(b.float() @ w).sum()) for b in chunk)
    assert g.read()["s"] == pytest.approx(want, rel=1e-4)


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
    assert K.LAUNCHES["groupnorm_silu"] == 14
    assert K.LAUNCHES["groupnorm_silu_bias"] == 14
    assert K.LAUNCHES["groupnorm_silu_residual_bias"] == \
        chip_smoke.K4_RESIDUAL_BIAS_PER_FORWARD


def test_fused_unet_matches_plain_bf16(cuda):
    """Small bf16 UNet (the serving dtype): K4 takes the bf16 conv outputs,
    gn1's cast and gn2's residual add and cast; within chip_smoke's
    UNET_REL_TOL of max |output| of the same model with no kernel, with 14
    K4 and 3 K3 launches a forward."""
    from vgd_tpu_torch.models.unet import UNet
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.device(cuda):
        fused = UNet(base_ch=16, time_emb_dim=32, dtype=torch.bfloat16,
                     fused=True)
        fused.init_parameters(g)
    x = torch.randn(2, 32, 32, 3, device=cuda, generator=g)
    t = torch.tensor([5, 900], device=cuda)
    with torch.inference_mode():
        with K.plain_reference():
            ref = fused(x, t)
        K.LAUNCHES.clear()
        out = fused(x, t)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    assert err <= chip_smoke.UNET_REL_TOL * float(ref.abs().max()), err
    assert K.LAUNCHES["groupnorm_silu"] == 14
    assert K.LAUNCHES["groupnorm_silu_shift"] == \
        chip_smoke.K4_SHIFT_PER_FORWARD
    assert K.LAUNCHES["groupnorm_silu_bias"] == 14
    assert K.LAUNCHES["groupnorm_silu_residual_bias"] == \
        chip_smoke.K4_RESIDUAL_BIAS_PER_FORWARD
    assert K.LAUNCHES["flash_attention"] == 3


def _biased_conv_block(self, x, t_emb):
    """The fused ConvBlock with biased convs (cuDNN's convolution, then the
    stock ``add_`` of its bias), the time projection as gn1's shift: what
    the block ran before K4 took the convs' biases."""
    res = x if self.residual_conv is None else self.residual_conv(x)
    h = self.gn1(self.conv1(x), out_dtype=self.dtype,
                 shift=self.time_proj(t_emb))
    return self.gn2(self.conv2(h), out_dtype=self.dtype, residual=res)


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_fused_unet_with_the_biases_in_k4_is_bit_equal_to_biased_convs(
        cuda, dtype, attention, monkeypatch):
    """The fused UNet whose K4 launches add the convs' biases is bit for
    bit the same UNet run with biased convs and the stock bias adds, and
    makes 14 K4 launches with a conv bias and 6 with a residual conv's."""
    from vgd_tpu_torch.models.unet import ConvBlock, UNet
    g = torch.Generator(device=cuda).manual_seed(9)
    with torch.device(cuda):
        fused = UNet(base_ch=16, time_emb_dim=32, dtype=dtype,
                     attention=attention, fused=True)
        fused.init_parameters(g)
        with torch.no_grad():
            for name, prm in fused.named_parameters():
                if name.endswith("bias"):
                    prm.copy_(0.5 * torch.randn(prm.shape, device=cuda,
                                                generator=g))
    x = torch.randn(4, 64, 64, 3, device=cuda, generator=g)
    t = torch.tensor([5, 900, 17, 400], device=cuda)
    with torch.inference_mode():
        K.LAUNCHES.clear()
        got = fused(x, t)
        assert K.LAUNCHES["groupnorm_silu_bias"] == 14
        assert K.LAUNCHES["groupnorm_silu_residual_bias"] == \
            chip_smoke.K4_RESIDUAL_BIAS_PER_FORWARD
        monkeypatch.setattr(ConvBlock, "_fused", _biased_conv_block)
        want = fused(x, t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fused_unet_without_attention_matches_plain_bf16(cuda):
    """The no-attention UNet (``--no-attn``) in bf16: within UNET_REL_TOL of
    max |output| of the same model with no kernel, with 14 K4 and no K3
    launch a forward."""
    from vgd_tpu_torch.models.unet import UNet
    g = torch.Generator(device=cuda).manual_seed(4)
    with torch.device(cuda):
        fused = UNet(base_ch=16, time_emb_dim=32, dtype=torch.bfloat16,
                     attention=False, fused=True)
        fused.init_parameters(g)
    x = torch.randn(2, 32, 32, 3, device=cuda, generator=g)
    t = torch.tensor([5, 900], device=cuda)
    with torch.inference_mode():
        with K.plain_reference():
            ref = fused(x, t)
        K.LAUNCHES.clear()
        out = fused(x, t)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    assert err <= chip_smoke.UNET_REL_TOL * float(ref.abs().max()), err
    assert dict(K.LAUNCHES) == {
        "groupnorm_silu": chip_smoke.CLI_K4_PER_FORWARD,
        "groupnorm_silu_shift": chip_smoke.K4_SHIFT_PER_FORWARD,
        "groupnorm_silu_bias": chip_smoke.CLI_K4_PER_FORWARD,
        "groupnorm_silu_residual_bias":
            chip_smoke.K4_RESIDUAL_BIAS_PER_FORWARD}


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


def test_vae_and_gan_steps_fused_match_stock_on_the_card(cuda):
    """Small f32 VAE, DCGAN and WGAN train steps with K1 (fused_conv) and
    the same weights and draws through the stock layers: the losses agree,
    and a step launches K1 once per fused layer and train-mode forward (VAE
    4 encoder layers x 1; at 32x32 the discriminator's 2 fused stages x 3
    DCGAN forwards, x 11 WGAN forwards)."""
    import dataclasses
    from vgd_tpu_torch.core import config as C
    from vgd_tpu_torch.train.gan import GANTrainer
    from vgd_tpu_torch.train.vae import VAETrainer
    g = torch.Generator(device=cuda).manual_seed(8)
    run = C.RunConfig(compute_dtype="float32", fused_conv=True)
    vcfg = C.VAEConfig(data=C.DataConfig(image_size=(64, 64), batch_size=4,
                                         noise_max_std=0.5, occlusion=False),
                       run=run, latent_dim=16, ngf=8)
    gcfg = C.GANConfig(data=C.DataConfig(image_size=(32, 32), batch_size=4),
                       run=run, latent_dim=16, ngf=8, ndf=8)
    cases = [(VAETrainer, vcfg, 64, 4, lambda t, b: t.train_step(
                 b, 0.5, noise=torch.randn(4, 64, 64, 3, device=cuda,
                                           generator=g),
                 eps=torch.randn(4, 16, device=cuda, generator=g))),
             (GANTrainer, gcfg, 32, 6, lambda t, b: t.train_step(
                 b, z=torch.randn(4, 16, device=cuda, generator=g))),
             (GANTrainer, dataclasses.replace(gcfg, wgan=True), 32, 22,
              lambda t, b: t.train_step_wgan(
                  b, z=torch.randn(6, 4, 16, device=cuda, generator=g)))]
    for cls, cfg, hw, per_step, step in cases:
        batch = torch.randint(0, 256, (4, hw, hw, 3), dtype=torch.uint8,
                              device=cuda, generator=g)
        fused = cls(cfg, (hw, hw, 3), device="cuda")
        fused.init(torch.Generator(device=cuda).manual_seed(0))
        stock = cls(dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, fused_conv=False)), (hw, hw, 3), device="cuda")
        stock.load(fused.state_dict())
        state = g.get_state()
        K.LAUNCHES.clear()
        mf = step(fused, batch)
        assert K.LAUNCHES["conv_bn_stats"] == per_step, cls
        g.set_state(state)
        ms = step(stock, batch)
        assert K.LAUNCHES["conv_bn_stats"] == per_step, cls
        for k in mf:
            assert abs(float(mf[k]) - float(ms[k])) <= \
                1e-4 * abs(float(ms[k])) + 1e-6, (cls, k)


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
        K.glow_coupling_fwd_cuda(p["ya"], p["w1f"], v["b1"], p["w2t"].t(),
                                 v["b2"], p["wz"], v["bz"], v["scale"],
                                 (3, 3), (1, 1))
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
    equals the saving one bit for bit; one launch of each; the plan's
    scratch in Python equals the C entry point's, in both dtypes."""
    fa, ba = k6_inputs(cuda, b, h, w, c, f, n, khw, dtype, 12)
    pad = (khw[0] // 2, khw[1] // 2)
    bf16 = dtype == torch.bfloat16
    plan = K.flow_stack_plan(b, h, w, c, f, khw, bf16=bf16)
    lib = _build.glow_flow_stack_lib()
    for backward in (0, 1):
        assert lib.vgd_glow_flow_stack_scratch_bytes(
            b, h, w, c, f, *khw, *pad, int(bf16), backward,
            K._k6_ints(plan)) == plan.scratch_bytes(bool(backward))
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


# every tile kind K6's bf16 path takes (mma64 for the forward's products,
# which the backward maps to wgmma), with splits forced where the product
# may split: (plan id, tiles, splits)
K6_PLANS = [
    ("mma64-split", {n: "mma64" for n, t, _ in K.K6_PRODUCTS if "mma64" in t},
     {"zconv": 2, "dwz": 3, "dw2": 2, "dw1": 2, "dya": 2}),
    ("wgmma", {n: t[0] for n, t, _ in K.K6_PRODUCTS},
     {"zconv": 2, "dwz": 2, "dw2": 3, "dw1": 3, "dya": 2}),
    ("wgmma-unsplit", {n: t[0] for n, t, _ in K.K6_PRODUCTS},
     {n: 1 for n, _, split in K.K6_PRODUCTS if split})]


@pytest.mark.parametrize("plan_id,tiles,splits", K6_PLANS,
                         ids=[p[0] for p in K6_PLANS])
@pytest.mark.parametrize("b,h,w,c,f,n,khw", [
    (2, 16, 16, 12, 128, 2, (3, 3)), (2, 8, 8, 48, 128, 2, (3, 3)),
    (3, 7, 5, 10, 40, 2, (3, 3))])
def test_k6_every_tile_and_split_matches_plain(cuda, b, h, w, c, f, n, khw,
                                               plan_id, tiles, splits):
    """K6 bf16 with each tile kind and forced splits against the plain
    versions (K5's 2e-2 of max |.|); the scratch size of the plan in
    Python equals the C entry point's."""
    fa, ba = k6_inputs(cuda, b, h, w, c, f, n, khw, torch.bfloat16, 15)
    pad = (khw[0] // 2, khw[1] // 2)
    plan = K.flow_stack_plan(b, h, w, c, f, khw, tiles=tiles, splits=splits)
    lib = _build.glow_flow_stack_lib()
    ints = K._k6_ints(plan)
    dims = [b, h, w, c, f, *khw, *pad, 1]
    for backward in (0, 1):
        assert lib.vgd_glow_flow_stack_scratch_bytes(
            *dims, backward, ints) == plan.scratch_bytes(bool(backward))
    y, xsave = K.glow_flow_stack_fwd(*fa, khw, pad, True, plan=plan)
    ref_y, ref_xsave = K.glow_flow_stack_fwd_plain(*fa, khw, pad, True)
    got = K.glow_flow_stack_bwd(ref_xsave, *ba, khw, pad, plan=plan)
    torch.cuda.synchronize()
    k5_close(y, ref_y, 2e-2, "y")
    k5_close(xsave, ref_xsave, 2e-2, "xsave")
    ref = K.glow_flow_stack_bwd_plain(ref_xsave, *ba, khw, pad)
    for name, a, r in zip(("dx", "danb", "dans", "dwt", "dw1", "db1", "dw2",
                           "db2", "dwz", "dbz", "dscale"), got, ref):
        k5_close(a, r, 2e-2, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k6_chunked_call_is_bit_equal_to_one_call(cuda, dtype):
    """``glow_flow_stack`` with chunk=8 (two launches of each direction)
    gives the same bits as one launch for the 16 flows: values and every
    gradient."""
    from vgd_tpu_torch.ops.glow_flow_stack import glow_flow_stack
    g = torch.Generator(device=cuda).manual_seed(16)
    n, c, f, khw = 16, 12, 64, (3, 3)

    def rnd(*shape, s=1.0):
        return s * torch.randn(*shape, device=cuda, generator=g)
    q, _ = torch.linalg.qr(rnd(n, c, c))
    leaves = dict(an_b=rnd(n, c, s=0.1), an_s=torch.exp(rnd(n, c, s=0.1)),
                  w1=rnd(n, 3, 3, c // 2, f, s=0.05), b1=rnd(n, f, s=0.05),
                  w2=rnd(n, 1, 1, f, f, s=0.05), b2=rnd(n, f, s=0.05),
                  wz=rnd(n, 3, 3, f, c // 2, s=0.01),
                  bz=rnd(n, c // 2, s=0.02), scale=rnd(n, c // 2, s=0.1))
    wt, x, cot = q.transpose(1, 2).contiguous(), rnd(2, 8, 8, c), rnd(
        2, 8, 8, c)
    out = []
    for chunk in (None, 8):
        t = {k: v.detach().clone().requires_grad_() for k, v in
             leaves.items()}
        tw, tx = wt.clone().requires_grad_(), x.clone().requires_grad_()
        tree = {"actnorm": {"b": t["an_b"], "s": t["an_s"]},
                "coupling": {"conv1": {"w": t["w1"], "b": t["b1"]},
                             "conv2": {"w": t["w2"], "b": t["b2"]},
                             "zero": {"w": t["wz"], "b": t["bz"],
                                      "scale": t["scale"]}}}
        before = dict(K.LAUNCHES)
        y = glow_flow_stack(tree, tw, tx, khw, (1, 1), dtype, chunk=chunk)
        y.backward(cot)
        launches = {k: K.LAUNCHES[k] - before.get(k, 0)
                    for k in ("glow_flow_stack_fwd", "glow_flow_stack_bwd")}
        assert launches == dict.fromkeys(launches, 1 if chunk is None else 2)
        out.append([y.detach(), tx.grad, tw.grad] + [t[k].grad for k in t])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_k6_refuses_a_grid_the_occupancy_does_not_allow(cuda):
    """A cooperative grid larger than the blocks that can be resident is
    refused with an error, never shrunk; the resident grid itself runs and
    so does a smaller one, with the same bits."""
    fa, ba = k6_inputs(cuda, 2, 8, 8, 12, 64, 2, (3, 3), torch.bfloat16, 17)
    lib = _build.glow_flow_stack_lib()
    full_f, full_b = (lib.vgd_glow_flow_stack_grid(1, d) for d in (0, 1))
    assert full_f > 0 and full_b > 0
    with pytest.raises(RuntimeError, match="launch failed"):
        K.glow_flow_stack_fwd(*fa, (3, 3), (1, 1), False, grid=full_f + 1)
    y, xsave = K.glow_flow_stack_fwd(*fa, (3, 3), (1, 1), True)
    with pytest.raises(RuntimeError, match="launch failed"):
        K.glow_flow_stack_bwd(xsave, *ba, (3, 3), (1, 1), grid=full_b + 1)
    small = K.glow_flow_stack_fwd(*fa, (3, 3), (1, 1), False,
                                  grid=full_f // 3)
    assert torch.equal(small, y)
    a = K.glow_flow_stack_bwd(xsave, *ba, (3, 3), (1, 1))
    b = K.glow_flow_stack_bwd(xsave, *ba, (3, 3), (1, 1), grid=full_b // 3)
    assert all(torch.equal(x, z) for x, z in zip(a, b))


def test_k6_sync_probe_runs_on_the_backward_grid(cuda):
    """The grid-sync probe launches K6's bf16 backward grid through n syncs
    and counts no kernel launch."""
    before = dict(K.LAUNCHES)
    for n in (0, 1, 64):
        K.glow_flow_stack_sync_probe(n, cuda)
    torch.cuda.synchronize()
    assert dict(K.LAUNCHES) == before


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
       (2, 9, 13, 12, 20, 1)]
    + [tuple(s[1:7]) for s in chip_smoke.K1_VAE_SHAPES
       + chip_smoke.K1_GAN_SHAPES]
    # the 64x64 VAE-GAN's discriminator stages at batch 64 (its encoder's
    # shapes are the VAE's)
    + [tuple(s[1:7]) for s in chip_smoke.K1_VAEGAN64_SHAPES
       if s[0].startswith("dis")])


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


# the registered ops (vgd::) against the direct kernel wrappers: the op's
# CUDA implementation is the wrapper, so the outputs are bit-equal and each
# call counts one launch
def test_registered_ops_equal_the_direct_wrappers(cuda):
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = (torch.randn(2, s, 64, device=cuda, generator=g)
               for s in (129, 33, 33))
    K.LAUNCHES.clear()
    assert torch.equal(torch.ops.vgd.flash_attention(q, k, v, 0.125),
                       K.flash_attention_cuda(q, k, v, 0.125))
    x = torch.randn(2, 8, 8, 64, device=cuda, generator=g)
    res = torch.randn(2, 8, 8, 64, device=cuda, generator=g).bfloat16()
    w, b = torch.rand(64, device=cuda) + 0.5, torch.randn(64, device=cuda)
    shift = torch.randn(2, 64, device=cuda, generator=g)
    cb, rb = torch.randn(64, device=cuda), torch.randn(64, device=cuda)
    for kw in ({}, {"out_dtype": torch.bfloat16, "residual": res},
               {"out_dtype": torch.bfloat16, "shift": shift},
               {"out_dtype": torch.bfloat16, "shift": shift,
                "conv_bias": cb},
               {"out_dtype": torch.bfloat16, "residual": res,
                "conv_bias": cb, "residual_bias": rb}):
        op = torch.ops.vgd.groupnorm_silu(x.bfloat16(), w, b, 8, 1e-5,
                                          kw.get("out_dtype"),
                                          kw.get("residual"),
                                          kw.get("shift"),
                                          kw.get("conv_bias"),
                                          kw.get("residual_bias"))
        assert torch.equal(op, K.groupnorm_silu_cuda(x.bfloat16(), w, b, 8,
                                                     1e-5, **kw))
    p, vec = k5_inputs(cuda, 2, 8, 8, 6, 64, torch.bfloat16, 21)
    args = (p["ya"], p["w1f"], vec["b1"], p["w2"], vec["b2"], p["wz"])
    op = torch.ops.vgd.glow_coupling_fwd(*args, p["wzf"], vec["bz"],
                                         vec["scale"], [3, 3], [1, 1])
    assert torch.equal(op, K.glow_coupling_fwd_cuda(
        *args, vec["bz"], vec["scale"], (3, 3), (1, 1), wzf=p["wzf"]))
    assert dict(K.LAUNCHES) == {"flash_attention": 2, "groupnorm_silu": 10,
                                "groupnorm_silu_shift": 4,
                                "groupnorm_silu_bias": 4,
                                "groupnorm_silu_residual_bias": 2,
                                "glow_coupling_fwd": 2}
    # an exported program may hand an op a layout it was not traced with:
    # the op copies to contiguous, the direct wrapper refuses
    strided = torch.randn(2, 64, 129, device=cuda,
                          generator=g).transpose(1, 2)
    assert torch.equal(torch.ops.vgd.flash_attention(strided, k, v, 0.125),
                       K.flash_attention_cuda(strided.contiguous(), k, v,
                                              0.125))
    xt = x.transpose(1, 2)
    assert torch.equal(torch.ops.vgd.groupnorm_silu(xt, w, b, 8, 1e-5, None,
                                                    None),
                       K.groupnorm_silu_cuda(xt.contiguous(), w, b))


def test_loaded_artifacts_count_their_launches(cuda, tmp_path):
    """A DDIM-3 DDPM artifact (3 K3 and 14 K4 a step, 7 of them with the
    time projection as their shift, all 14 with their conv's bias, 6 with
    a 1x1 residual conv's bias) and a fused-coupling
    Glow artifact (one K5 a flow), exported from seeded checkpoints and
    loaded on the card, launch exactly those kernels and agree with the
    eager path on the same draws."""
    import numpy as np
    from vgd_tpu_torch.core.config import (DataConfig, DiffusionConfig,
                                           GlowConfig, RunConfig, to_dict)
    from vgd_tpu_torch.core.rng import seed_all
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.io.export import (export_serving, load_artifact,
                                         run_artifact, serving_draws)
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    from vgd_tpu_torch.train.glow import GlowTrainer
    cfg = DiffusionConfig(data=DataConfig(image_size=(32, 32)), base_ch=16,
                          time_emb_dim=32, timesteps=20,
                          run=RunConfig(out_dir=str(tmp_path / "ddpm")))
    tr = DiffusionTrainer(cfg, (32, 32, 3), device=cuda)
    tr.init(seed_all(0, cuda))
    L.save_checkpoint(cfg, tr, 1)
    call, meta = load_artifact(export_serving(
        "diffusion", cfg, n=2, ddim_steps=3,
        artifact_path=str(tmp_path / "d.pt2")), device="cuda")
    draws = serving_draws(meta, 1)
    K.LAUNCHES.clear()
    out = run_artifact(seed=1, loaded=(call, meta))
    assert dict(K.LAUNCHES) == {"flash_attention": 9, "groupnorm_silu": 42,
                                "groupnorm_silu_shift": 21,
                                "groupnorm_silu_bias": 42,
                                "groupnorm_silu_residual_bias": 18}
    want = tr.ddim_sample(draws["xt"].to(cuda), 3, eta=0.0).cpu().numpy()
    assert np.array_equal(out, want)

    gcfg = GlowConfig(data=DataConfig(image_size=(16, 16), normalize=False),
                      n_flows=2, n_blocks=2, filter_size=64,
                      fused_coupling=True,
                      run=RunConfig(out_dir=str(tmp_path / "glow")))
    gt = GlowTrainer(gcfg, (16, 16, 3), device=cuda)
    gt.init(seed_all(0, cuda))
    Checkpointer(str(tmp_path / "glow" / "ckpt")).save(
        1, gt.model.state_dict(), to_dict(gcfg))
    call, meta = load_artifact(export_serving(
        "glow", gcfg, n=2, artifact_path=str(tmp_path / "g.pt2")),
        device="cuda")
    K.LAUNCHES.clear()
    out = run_artifact(seed=1, loaded=(call, meta))
    assert dict(K.LAUNCHES) == {"glow_coupling_fwd": 4}
    assert np.isfinite(out).all() and out.shape == (2, 16, 16, 3)
