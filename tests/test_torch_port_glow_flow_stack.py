"""K6's plain versions and the port's ``flow_stack`` path against the JAX
package, on the CPU (JAX's flow-stack kernel in interpret mode).

* (a) the plain forward, with and without saving each flow's input, against
  JAX's ``glow_flow_stack``: f32 within 1e-5 of max |y| (sums in other
  orders; observed about 2.4e-7), bf16 within 2e-2 max |y| + 2e-3 (a cd rounding of y1, h1 or h2
  that goes the other way moves a term by one bf16 ulp); each saved input
  equal to the output of the flows before it;
* (b) every input's gradient through ``_FlowStack`` against ``jax.vjp`` of
  JAX's ``glow_flow_stack``, f32, within 5e-4 (1e-3 + max |g|), the JAX
  flow-stack test's bound (observed below 1e-6 of it);
* (c) one launch per flow (``chunk=1``) against one for all, values and
  gradients, rtol 1e-5 / atol 1e-6;
* (d) the ``Glow`` forward and the loss gradients with ``flow_stack=True``
  against JAX's on bridged parameters (forward at the port Glow test's 1e-5
  of max |value|, observed 5.8e-7; gradients at (b)'s bound, observed
  1.2e-6 of (1e-3 + max |g|)), and the int threshold routing only the
  small blocks;
* (e) the EEG variant's (3, 1) kernel, values and gradients;
* (f) ``GlowTrainer(flow_stack=True)`` free-running 5 steps from JAX's state
  in lockstep with JAX's: losses within rtol 1e-5 (observed 9.1e-8, as on
  the per-flow path);
  and the no-grad likelihood pass takes the forward that saves nothing;
* (g) the config, the CLI flag, the checkpoint's record of it, and
  ``sample`` / ``eval-glow`` from a ``flow_stack`` checkpoint;
* the kernel build names each library by its source and the local headers
  it includes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.models import glow as JG
from vgd_tpu.ops import glow_flow_stack as JFS
from vgd_tpu.train.glow import GlowTrainer as JT
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.jax_params import (from_jax_glow_params,
                                         load_jax_glow_state)
from vgd_tpu_torch.models import glow as PG
from vgd_tpu_torch.ops import _build
from vgd_tpu_torch.ops import glow_flow_stack as PFS
from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.train.glow import GlowTrainer as PT

F32_REL = 1e-5
BF16_REL, BF16_ATOL = 2e-2, 2e-3
GRAD_REL, GRAD_FLOOR = 5e-4, 1e-3
LOCKSTEP_RTOL = 1e-5
# (B, H, W, c, f, K)
SHAPES = [(2, 8, 8, 6, 16, 3), (2, 4, 4, 12, 32, 2)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flows(seed, n_flows, c, f, khw=(3, 3)):
    """A JAX flow stack (leading K) with every trainable leaf perturbed (a
    non-zero ZeroConv, ActNorm not the identity), its transposed PLU
    weights, and both as numpy."""
    rng = np.random.default_rng(seed)
    flows = jax.vmap(lambda k: JG._flow_init(k, c, f, *khw))(
        jax.random.split(jax.random.key(seed), n_flows))
    flows = _np(flows)
    for node, names in ((flows["actnorm"], ("b", "s")),
                        (flows["invconv"], ("L", "U", "log_s"))):
        for n in names:
            node[n] = node[n] + 0.1 * rng.standard_normal(
                node[n].shape).astype(np.float32)
    for layer in flows["coupling"].values():
        for n in layer:
            layer[n] = layer[n] + 0.05 * rng.standard_normal(
                layer[n].shape).astype(np.float32)
    wt = np.asarray(jax.vmap(JG.Glow._plu_weight)(flows["invconv"])
                    ).swapaxes(1, 2).copy()
    return flows, wt


def _torch_tree(flows, grad=False):
    return {"actnorm": {n: torch.from_numpy(flows["actnorm"][n])
                        .requires_grad_(grad) for n in ("b", "s")},
            "coupling": {layer: {n: torch.from_numpy(v).requires_grad_(grad)
                                 for n, v in leaves.items()}
                         for layer, leaves in flows["coupling"].items()}}


def _leaves(tree):
    """The 10 stacked leaves in K6's argument order (wt apart)."""
    cpl = tree["coupling"]
    return [tree["actnorm"]["b"], tree["actnorm"]["s"], cpl["conv1"]["w"],
            cpl["conv1"]["b"], cpl["conv2"]["w"], cpl["conv2"]["b"],
            cpl["zero"]["w"], cpl["zero"]["b"], cpl["zero"]["scale"]]


def _jax_stack(flows, wt, x, khw, pad, cd=jnp.float32):
    return JFS.glow_flow_stack(jax.tree_util.tree_map(jnp.asarray, flows),
                               jnp.asarray(wt), jnp.asarray(x), khw, pad,
                               compute_dtype=cd, interpret=True)


def _close(got, want, rel, atol=0.0, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()) + atol, (what, err)


def _packed_args(tree, wt, cd):
    p = PFS._pack(tree["coupling"]["conv1"]["w"], tree["coupling"]["conv2"]["w"],
                  tree["coupling"]["zero"]["w"], cd, backward=False)
    cpl = tree["coupling"]
    return (tree["actnorm"]["b"], tree["actnorm"]["s"], torch.from_numpy(wt),
            p["w1f"], cpl["conv1"]["b"], p["w2"], cpl["conv2"]["b"], p["wz"],
            cpl["zero"]["b"], cpl["zero"]["scale"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,f,n", SHAPES)
def test_plain_forward_matches_jax(b, h, w, c, f, n, dtype):
    flows, wt = _flows(c + f, n, c, f)
    x = np.random.default_rng(1).standard_normal((b, h, w, c)).astype(
        np.float32)
    cd = getattr(torch, dtype)
    rel, atol = (F32_REL, 0.0) if dtype == "float32" else (BF16_REL,
                                                           BF16_ATOL)
    want = _jax_stack(flows, wt, x, (3, 3), (1, 1), getattr(jnp, dtype))
    args = (torch.from_numpy(x), *_packed_args(_torch_tree(flows), wt, cd),
            (3, 3), (1, 1))
    y = K.glow_flow_stack_fwd(*args, save=False)
    y_saved, xsave = K.glow_flow_stack_fwd(*args, save=True)
    _close(y, want, rel, atol, "y")
    assert torch.equal(y, y_saved)
    assert xsave.shape == (n, b, h, w, c)
    assert torch.equal(xsave[0], torch.from_numpy(x))
    # flow k's input is the output of the flows before it
    for k in range(1, n):
        assert torch.equal(xsave[k], K.glow_flow_stack_fwd(
            args[0], *(t[:k] for t in args[1:11]), *args[11:], save=False))


def _vjp_case(flows, wt, x, khw, pad):
    """Every input's gradient of sum(y * cot): JAX's vjp and the port's
    autograd through _FlowStack, f32."""
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda fl, w, xx: _jax_stack(fl, w, xx, khw, pad),
                     jax.tree_util.tree_map(jnp.asarray, flows),
                     jnp.asarray(wt), jnp.asarray(x))
    gf, gw, gx = vjp(jnp.asarray(cot))
    tree = _torch_tree(flows, grad=True)
    twt = torch.from_numpy(wt).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y = PFS.glow_flow_stack(tree, twt, tx, khw, pad, torch.float32)
    (y * torch.from_numpy(cot)).sum().backward()
    got = [t.grad for t in _leaves(tree)] + [twt.grad, tx.grad]
    want = [np.asarray(a) for a in _leaves(gf)] + [np.asarray(gw),
                                                   np.asarray(gx)]
    names = ["an_b", "an_s", "w1", "b1", "w2", "b2", "wz", "bz", "scale",
             "wt", "x"]
    for name, a, r in zip(names, got, want):
        assert a is not None, name
        _close(a, r, GRAD_REL, GRAD_REL * GRAD_FLOOR, name)


@pytest.mark.parametrize("b,h,w,c,f,n", SHAPES)
def test_vjp_matches_jax(b, h, w, c, f, n):
    flows, wt = _flows(2 * c + f, n, c, f)
    x = np.random.default_rng(3).standard_normal((b, h, w, c)).astype(
        np.float32)
    _vjp_case(flows, wt, x, (3, 3), (1, 1))


def test_eeg_kernel_matches_jax():
    """(e) one EEG-variant block: (3, 1) kernel, padding on time only."""
    flows, wt = _flows(5, 2, 8, 16, khw=(3, 1))
    x = np.random.default_rng(4).standard_normal((2, 10, 1, 8)).astype(
        np.float32)
    want = _jax_stack(flows, wt, x, (3, 1), (1, 0))
    y = PFS.glow_flow_stack(_torch_tree(flows), torch.from_numpy(wt),
                            torch.from_numpy(x), (3, 1), (1, 0),
                            torch.float32)
    _close(y, want, F32_REL, what="y")
    _vjp_case(flows, wt, x, (3, 1), (1, 0))


def test_chunks_match_one_call():
    """(c) chunk=1 (one call per flow, chained) equals chunk=K."""
    flows, wt = _flows(9, 3, 6, 16)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, 8, 6)).astype(np.float32))
    out = []
    for chunk in (1, 3):
        tree = _torch_tree(flows, grad=True)
        twt = torch.from_numpy(wt).requires_grad_()
        tx = x.clone().requires_grad_()
        y = PFS.glow_flow_stack(tree, twt, tx, (3, 3), (1, 1), torch.float32,
                                chunk=chunk)
        torch.tanh(y).sum().backward()
        out.append([y.detach()] + [t.grad for t in _leaves(tree)]
                   + [twt.grad, tx.grad])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


B, HW, FLOWS, BLOCKS, F, LR = 4, 16, 2, 2, 32, 1e-4


def _models(flow_stack, seed=0):
    """JAX and port Glow, the same perturbed parameters over the bridge."""
    jm = JG.Glow(in_channels=3, n_flows=FLOWS, n_blocks=BLOCKS,
                 filter_size=F, compute_dtype=jnp.float32,
                 flow_stack=flow_stack)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if {"P", "s_sign"} & {getattr(k, "key", "") for k in path}:
            return a
        return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(
        perturb, _np(jm.init(jax.random.key(seed))))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    pm = PG.Glow(in_channels=3, n_flows=FLOWS, n_blocks=BLOCKS,
                 filter_size=F, flow_stack=flow_stack)
    pm.load_state_dict(from_jax_glow_params(_np(params), pm), strict=True)
    return jm, params, pm


def test_glow_forward_and_grads_match_jax():
    """(d) log_p, logdet, every z, and the loss gradients of every
    parameter, flow_stack=True on both sides."""
    jm, params, pm = _models(True)
    x = (0.3 * np.random.default_rng(1).standard_normal(
        (2, HW, HW, 3))).astype(np.float32)

    def jloss(p):
        lp, ld, z = jm.forward(p, jnp.asarray(x))
        return JG.calc_loss(lp, jnp.mean(ld), HW, 32.0)[0], (lp, ld, z)
    (_, (lp_j, ld_j, z_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(
        params)
    lp, ld, zs = pm(torch.from_numpy(x))
    for a, r in zip([lp, ld, *zs], [lp_j, ld_j, *z_j]):
        _close(a, r, F32_REL)
    PG.calc_loss(lp, ld.mean(), HW, 32.0)[0].backward()
    want = from_jax_glow_params(_np(g_j), pm)
    for name, p in pm.named_parameters():
        _close(p.grad, want[name], GRAD_REL, GRAD_REL * GRAD_FLOOR, name)


def test_threshold_routes_only_small_blocks(monkeypatch):
    """(d) an int N sends only the blocks whose squeezed h*w <= N to K6;
    the result equals the per-flow model's."""
    calls = []
    real = PG.glow_flow_stack

    def spy(flows, wt, y, *args, **kwargs):
        calls.append(y.shape[1] * y.shape[2])
        return real(flows, wt, y, *args, **kwargs)
    monkeypatch.setattr(PG, "glow_flow_stack", spy)
    _, params, stock = _models(False)
    hybrid = PG.Glow(in_channels=3, n_flows=FLOWS, n_blocks=BLOCKS,
                     filter_size=F, flow_stack=16)
    hybrid.load_state_dict(stock.state_dict())
    x = torch.from_numpy((0.3 * np.random.default_rng(2).standard_normal(
        (B, HW, HW, 3))).astype(np.float32))
    with torch.no_grad():
        want, got = stock(x), hybrid(x)
    # 16x16 squeezes to 8x8 (h*w 64), then 4x4 (16): only block 1 runs K6
    assert calls == [16]
    for a, r in zip([got[0], got[1], *got[2]], [want[0], want[1], *want[2]]):
        _close(a, r, F32_REL)
    assert PG.Glow(filter_size=8, flow_stack=True)._use_flow_stack(4096)
    assert not PG.Glow(filter_size=8)._use_flow_stack(1)
    assert PG.Glow(filter_size=8, flow_stack=16)._use_flow_stack(16)
    assert not PG.Glow(filter_size=8, flow_stack=16)._use_flow_stack(64)
    # init mode keeps the per-flow path (the ActNorm statistics)
    calls.clear()
    hybrid.init_actnorm(x)
    assert calls == []


def _cfgs():
    common = dict(n_flows=FLOWS, n_blocks=BLOCKS, filter_size=F, lr=LR,
                  flow_stack=True)
    jc = JC.GlowConfig(
        data=JC.DataConfig(image_size=(HW, HW), batch_size=B,
                           normalize=False),
        run=JC.RunConfig(compute_dtype="float32"), **common)
    pc = PC.GlowConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=B,
                           normalize=False),
        run=PC.RunConfig(compute_dtype="float32"), **common)
    return jc, pc


def _draws(i):
    batch = np.random.default_rng(300 + i).integers(0, 256, (B, HW, HW, 3),
                                                     dtype=np.uint8)
    key = jax.random.PRNGKey(300 + i)
    return batch, key, np.array(jax.random.uniform(key, batch.shape))


def test_trainer_lockstep_with_jax():
    """(f) init_step and 5 steps in a row from JAX's init, same batches and
    dequantisation noise; then the no-grad likelihood forward runs the
    no-save kernel's plain version twice (once per block) and nothing
    else of K6."""
    jc, pc = _cfgs()
    jt = JT(jc, (HW, HW, 3))
    st = jt.init(jax.random.PRNGKey(0))
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    load_jax_glow_state(tr, jax.device_get(st))
    batch, key, noise = _draws(-1)
    st = jt.init_step(st, jnp.asarray(batch), key)
    tr.init_step(torch.from_numpy(batch), noise=torch.from_numpy(noise))
    want, got = [], []
    for i in range(5):
        batch, key, noise = _draws(i)
        st, m = jt.train_step(st, jnp.asarray(batch), key)
        want.append(float(m["loss"]))
        got.append(float(tr.train_step(torch.from_numpy(batch),
                                       noise=torch.from_numpy(noise))["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOCKSTEP_RTOL)


def test_no_grad_forward_takes_the_nosave_kernel(monkeypatch):
    """(f) GlowTrainer.forward (no grad) reaches K6's forward without
    saves, once per block; a train step the saving forward and the
    backward."""
    _, pc = _cfgs()
    tr = PT(pc, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(1))
    seen = []
    fwd, bwd = K.glow_flow_stack_fwd, K.glow_flow_stack_bwd

    def spy_fwd(*args):
        seen.append("fwd" if args[-1] else "fwd_nosave")
        return fwd(*args)

    def spy_bwd(*args):
        seen.append("bwd")
        return bwd(*args)
    monkeypatch.setattr(K, "glow_flow_stack_fwd", spy_fwd)
    monkeypatch.setattr(K, "glow_flow_stack_bwd", spy_bwd)
    batch = torch.from_numpy(_draws(0)[0])
    tr.init_step(batch, noise=torch.zeros(batch.shape))
    assert seen == []
    lp, ld, zs = tr.forward(torch.rand(B, HW, HW, 3))
    assert seen == ["fwd_nosave"] * BLOCKS and not lp.requires_grad
    seen.clear()
    tr.train_step(batch, noise=torch.zeros(batch.shape))
    assert seen == ["fwd"] * BLOCKS + ["bwd"] * BLOCKS


@pytest.mark.parametrize("bad", [0, -3, 2.5, "all", None])
def test_config_accepts_bool_or_positive_int(bad):
    """(g) False, True and a positive int; anything else is refused."""
    assert PC.GlowConfig(flow_stack=True).flow_stack is True
    assert PC.GlowConfig(flow_stack=256).flow_stack == 256
    with pytest.raises(ValueError, match="flow_stack"):
        PC.GlowConfig(flow_stack=bad)
    with pytest.raises(ValueError, match="flow_stack"):
        PG.Glow(n_flows=1, n_blocks=1, filter_size=4, flow_stack=bad)


@pytest.mark.parametrize("flag,want", [(["--flow-stack"], True),
                                       (["--flow-stack", "16"], 16)])
def test_cli_flow_stack_trains_and_serves(tmp_path, capsys, flag, want):
    """(g) the bare flag is every block, an int the h*w threshold; the
    checkpoint's config records it; sample and eval-glow rebuild the model
    with it and run from that checkpoint."""
    common = ["--out-dir", str(tmp_path), "--image-size", str(HW),
              "--compute-dtype", "float32", "--device", "cpu",
              "--n-flows", "2", "--n-blocks", "2", "--filter-size", "16",
              "--batch-size", "2", "--dataset-size", "8"] + flag
    assert cli.main(["glow", "--iters", "2", "--sample-every", "2"]
                    + common) == 0
    assert "iter 2/2" in capsys.readouterr().out
    ckpt = torch.load(tmp_path / "ckpt" / "00000002.pt", weights_only=True)
    assert ckpt["config"]["flow_stack"] == want
    assert type(ckpt["config"]["flow_stack"]) is type(want)
    assert cli.main(["sample", "--family", "glow", "-n", "3"] + common) == 0
    imgs = np.load(tmp_path / "glow_samples.npy")
    assert imgs.shape == (3, HW, HW, 3) and np.isfinite(imgs).all()
    assert cli.main(["eval-glow", "--max-batches", "1"] + common) == 0
    assert "ssim" in capsys.readouterr().out


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edit to a header that a source includes with quotes renames (so
    rebuilds) the source's library; an unrelated file does not."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "a.cuh").write_text("#define A 1\n")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "b.cuh"\nint x;\n')
    first = _build._library_path(src)
    assert [h.name for h in _build._local_headers(src)] == ["b.cuh", "a.cuh"]
    (tmp_path / "other.cuh").write_text("#define B 2\n")
    assert _build._library_path(src) == first
    (tmp_path / "a.cuh").write_text("#define A 2\n")
    second = _build._library_path(src)
    assert second != first and second.name.startswith("k-")
    # the real sources: K5 and K6 hash their tensor-core tile header and,
    # through it, the shared GEMM header (K6's f32 checks run on it)
    for name, headers in (("glow_coupling.cu", ["glow_mma.cuh",
                                                "glow_gemm.cuh"]),
                          ("glow_flow_stack.cu", ["glow_mma.cuh",
                                                  "glow_gemm.cuh"])):
        assert [h.name for h in _build._local_headers(
            _build.CSRC_DIR / name)] == headers
