"""Glow's pipeline parallelism in the port (``parallel/pipeline_parallel.py``)
against the JAX package on the CPU, in f32.

The port's ranks are fresh gloo processes (``parallel.launch.spawn``),
started in a thread while this process runs the one-process references
and JAX:

* ``pp_flow_stack`` on a data=1 x model=2 mesh, M = 2 and 4 microbatches,
  against JAX's sequential flow scan (``tests/test_pipeline_parallel.py``'s
  ``_reference``) and JAX's own ``pp_flow_stack`` on a data=1 x model=2
  mesh: output and per-microbatch logdet at JAX's rtol 2e-5 / atol 2e-6;
  the input gradient and every flow gradient (summed over the stages) of
  sum(y * r) + sum(logdet) at rtol 5e-5 / atol 5e-6, against JAX's
  sequential gradient. ZeroConvs and ActNorm are perturbed so every
  gradient is real;
* ``pp_train_step`` against JAX's sequential training step (the check of
  ``tests/test_tp_production.py::test_pp_train_step_matches_sequential``,
  on its sequential reference only);
* ``run_glow --pp-stages 2`` with ``fused_coupling`` (K5's plain versions
  here) on 2 ranks (data=1 x model=2) and on 4 (data=2 x model=2) against
  one process without a pipeline, held as
  ``tests/test_torch_port_parallel_loops.py`` holds data parallelism, the
  ranks bit-equal after every step; a PP checkpoint resumed in one process
  and a one-process checkpoint resumed under PP;
* the CLI sizing ``--mesh-model`` from ``--pp-stages`` as JAX's does, the
  config's fields, and the refusals in JAX's words.
"""
import dataclasses
import math
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_parallel_loops import (_close_logs, _close_metrics,
                                            _close_state, _losses, _real)

from vgd_tpu import cli as jax_cli
from vgd_tpu.core import config as JC
from vgd_tpu.models import glow as JG
from vgd_tpu.parallel.mesh import build_mesh as jax_mesh
from vgd_tpu.parallel.pipeline_parallel import pp_flow_stack as jax_pp
from vgd_tpu.train import loop as JL
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.parallel import mesh as PM
from vgd_tpu_torch.parallel import workers
from vgd_tpu_torch.parallel.launch import spawn
from vgd_tpu_torch.train import loop as L

REL = 1e-5
FWD_RTOL, FWD_ATOL = 2e-5, 2e-6        # JAX's, tests/test_pipeline_parallel
GRAD_RTOL, GRAD_ATOL = 5e-5, 5e-6      # JAX's, its gradient test
MICROBATCHES = (2, 4)
E = 2                                  # iterations before the resume
MESH12, MESH22 = PC.MeshConfig(data=1, model=2), PC.MeshConfig(data=2,
                                                               model=2)


def _glow_cfg(out, mesh=PC.MeshConfig(), **kw):
    return PC.GlowConfig(
        data=PC.DataConfig(image_size=(16, 16), batch_size=8,
                           dataset_size=24, normalize=False),
        run=PC.RunConfig(out_dir=str(out), compute_dtype="float32",
                         sample_every_iters=2, checkpoint_every_iters=2,
                         mesh=mesh),
        **{"n_flows": 2, "n_blocks": 2, "filter_size": 16,
           "fused_coupling": True, **kw})


def _pp(out, mesh):
    return _glow_cfg(out, mesh, pp_stages=2)


def _loop(cfg, n_iter, resume=False):
    return dict(family="glow", cfg=cfg, n_iter=n_iter, resume=resume)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v, np.float32)})
    return out


def _torch(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _reference(glow, flows, xs):
    """JAX's sequential flow scan (tests/test_pipeline_parallel.py)."""
    hw = xs.shape[1] * xs.shape[2]

    def body(carry, fp):
        y, l = carry
        y, dl, _ = glow._flow_fwd(fp, y, hw, False)
        return (y, l + dl), None
    (y, logdet), _ = jax.lax.scan(body, (xs, jnp.zeros((), xs.dtype)), flows)
    return y, logdet


def _stack_case():
    """JAX's pipeline test setup with every trainable leaf but P / s_sign
    perturbed (n_flows 4, width 16), its input, an output cotangent, and
    per microbatch count JAX's pipeline output and logdets and the
    sequential gradients of sum(y * r) + M * logdet."""
    glow = JG.Glow(in_channels=3, n_flows=4, n_blocks=1, filter_size=16)
    flows = glow.init(jax.random.key(0))["block0"]["flows"]
    rng = np.random.default_rng(0)
    flows = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in ("P", "s_sign") else
        a + 0.1 * rng.normal(size=a.shape).astype(np.float32), flows)
    xs = glow._squeeze(jax.random.normal(jax.random.key(5), (8, 8, 8, 3))
                       * 0.3)
    r = jax.random.normal(jax.random.key(3), xs.shape)
    ref_y, ref_ld = _reference(glow, flows, xs)
    mesh = jax_mesh(data=1, model=2, devices=jax.devices()[:2])
    per_m = {}
    for n_mb in MICROBATCHES:
        y, ld = jax_pp(mesh, glow, flows, xs, n_mb)

        def loss(fl, x):
            yy, l = _reference(glow, fl, x)
            return jnp.sum(yy * r) + n_mb * l
        dfl, dx = jax.grad(loss, argnums=(0, 1))(flows, xs)
        per_m[n_mb] = {"y": np.asarray(y), "ld": np.asarray(ld),
                       "dx": np.asarray(dx), "grads": _flat(dfl)}
    port = {"kw": dict(in_channels=3, n_flows=4, n_blocks=1,
                       filter_size=16),
            "flows": _torch(_flat(flows)), "x": torch.from_numpy(
                np.array(xs)), "gy": torch.from_numpy(np.array(r)),
            "microbatches": list(MICROBATCHES)}
    return port, {"y": np.asarray(ref_y), "ld": float(ref_ld),
                  "per_m": per_m}


def _train_case():
    """tests/test_tp_production.py::test_pp_train_step_matches_sequential:
    the sequential step's loss and flows after Adam (lr 1e-3)."""
    glow = JG.Glow(in_channels=3, n_flows=4, n_blocks=1, filter_size=32)
    flows = glow.init(jax.random.key(0))["block0"]["flows"]
    xs = glow._squeeze(jax.random.normal(jax.random.key(1), (8, 8, 8, 3))
                       * 0.3)
    hw = xs.shape[1] * xs.shape[2]
    tx = optax.adam(1e-3)

    def seq_loss(fl):
        def body(carry, fp):
            y, l = carry
            y, dl, _ = glow._flow_fwd(fp, y, hw, False)
            return (y, l + dl), None
        (y, ld), _ = jax.lax.scan(body, (xs, jnp.zeros(())), fl)
        log_p = -0.5 * jnp.sum(jnp.square(y), axis=(1, 2, 3)) \
            - 0.5 * math.log(2 * math.pi) * y[0].size
        return -(jnp.mean(log_p) + ld)
    loss, grads = jax.value_and_grad(seq_loss)(flows)
    upd, _ = tx.update(grads, tx.init(flows), flows)
    new = optax.apply_updates(flows, upd)
    port = {"kw": dict(in_channels=3, n_flows=4, n_blocks=1,
                       filter_size=32),
            "flows": _torch(_flat(flows)), "x": torch.from_numpy(
                np.array(xs)), "lr": 1e-3, "microbatches": 4}
    return port, {"loss": float(loss), "flows": _flat(new)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("pp")
    ref = workers.train_loop(**_loop(_glow_cfg(root / "ref"), E + 1))
    shutil.copytree(root / "ref", root / "ppres")
    ck = Checkpointer(str(root / "ppres" / "ckpt"))
    for s in ck.all_steps():
        if s > E:
            os.remove(ck._path(s))
    four = [("train_loops", dict(jobs=[
        _loop(_pp(root / "pp22", MESH22), E)]))]
    parts = {}

    def four_ranks():
        try:
            parts[4] = spawn("vgd_tpu_torch.parallel.workers:bodies", 4,
                             four, timeout=600)
        except Exception as e:  # noqa: BLE001 - raised below
            parts["error"] = e
    thread = threading.Thread(target=four_ranks)
    thread.start()
    stack, train = _stack_case(), _train_case()
    two = [("mp_checks", dict(inp={"mesh": (1, 2), "pp": stack[0],
                                   "pp_train": train[0]})),
           ("train_loops", dict(jobs=[
               _loop(_pp(root / "pp12", MESH12), E),
               _loop(_pp(root / "ppres", MESH12), E + 1, resume=True)]))]
    parts[2] = spawn("vgd_tpu_torch.parallel.workers:bodies", 2, two,
                     timeout=600)
    thread.join()
    if "error" in parts:
        raise parts["error"]
    one_resume = workers.train_loop(**_loop(_glow_cfg(root / "pp12"), E + 1,
                                            resume=True))
    mp = [p[0] for p in parts[2]]
    pp12, ppres = zip(*[p[1] for p in parts[2]])
    return dict(root=root, ref=ref, mp=mp, stack=stack[1], train=train[1],
                pp={"pp12": list(pp12), "pp22": [p[0][0] for p in
                                                 parts[4]]},
                ppres=list(ppres), one_resume=one_resume)


# ------------------------------------------------------ the flow stack
@pytest.mark.parametrize("i", range(len(MICROBATCHES)),
                         ids=[f"M{m}" for m in MICROBATCHES])
def test_pp_flow_stack_matches_jax(runs, i):
    """Output and per-microbatch logdets on 2 stages against JAX's
    sequential scan and JAX's pipeline, the same bits on both ranks."""
    want = runs["stack"]
    jpp = want["per_m"][MICROBATCHES[i]]
    got = [p["pp"][i] for p in runs["mp"]]
    for g in got:
        for ref_y in (want["y"], jpp["y"]):
            np.testing.assert_allclose(g["y"].numpy(), ref_y,
                                       rtol=FWD_RTOL, atol=FWD_ATOL)
        np.testing.assert_allclose(g["ld"].numpy(), jpp["ld"], rtol=FWD_RTOL)
        np.testing.assert_allclose(
            g["ld"].numpy(), np.full(MICROBATCHES[i], want["ld"]),
            rtol=FWD_RTOL)
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k


@pytest.mark.parametrize("i", range(len(MICROBATCHES)),
                         ids=[f"M{m}" for m in MICROBATCHES])
def test_pp_gradients_match_jax(runs, i):
    """dx and every flow leaf's gradient, summed over the stages, against
    JAX's sequential gradient (the PLU buffers get none)."""
    jpp = runs["stack"]["per_m"][MICROBATCHES[i]]
    got = runs["mp"][0]["pp"][i]
    np.testing.assert_allclose(got["dx"].numpy(), jpp["dx"],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    want = {k: v for k, v in jpp["grads"].items()
            if not k.endswith((".P", ".s_sign"))}
    assert set(want) <= set(got) and not {"invconv.P",
                                          "invconv.s_sign"} & set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_pp_train_step_matches_sequential(runs):
    """pp_train_step on 2 stages, 4 microbatches: the loss and the flows
    after Adam against JAX's sequential step (JAX's own bounds)."""
    want = runs["train"]
    for part in runs["mp"]:
        got = part["pp_train"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=1e-5, atol=1e-6)
        for k, w in want["flows"].items():
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


# --------------------------------------------------------------- the loops
@pytest.mark.parametrize("tag", ["pp12", "pp22"])
def test_pp_run_glow_matches_one_process(runs, tag):
    """run_glow --pp-stages 2 with fused_coupling against one process:
    every step's global losses and every logged loss, the state against the
    one-process checkpoint at the same iteration, the run's own checkpoint
    exactly its final state, and every rank bit-equal after every step."""
    ref = runs["ref"]
    res = runs["pp"][tag]
    for r in res:
        _close_metrics(_losses(r), _losses(ref)[:E], REL, tag)
        _close_logs(r["log"], ref["log"][:len(r["log"])], REL, tag)
    fps = [[r["fingerprint"] for r in p["steps"]] for p in res]
    assert all(f == fps[0] for f in fps)
    assert all(torch.equal(res[0]["state"][k], p["state"][k])
               for p in res for k in res[0]["state"])
    ckpt = Checkpointer(str(runs["root"] / "ref" / "ckpt")).load(E)
    _close_state(res[0]["state"], ckpt["params"], tag,
                 _real(ckpt, ref["adam_keys"]))
    own = Checkpointer(str(runs["root"] / tag / "ckpt")).load(E)
    assert all(torch.equal(own["params"][k], v)
               for k, v in res[0]["state"].items())


def test_pp_resume_across_world_sizes(runs):
    """One process resumes the PP checkpoint and 2 PP ranks resume the
    one-process checkpoint: each continues as the one-process run did."""
    ref = runs["ref"]
    real = _real(Checkpointer(str(runs["root"] / "ref" / "ckpt")).load(),
                 ref["adam_keys"])
    for what, res in (("one-resume", runs["one_resume"]),
                      ("pp-resume", runs["ppres"][0])):
        _close_metrics(_losses(res), _losses(ref)[E:], REL, what)
        _close_state(res["state"], ref["state"], what, real)
        assert res["opt_step"] == ref["opt_step"]
    assert runs["ppres"][0]["fingerprint"] == runs["ppres"][1]["fingerprint"]


# ------------------------------------------------- CLI, config, refusals
@pytest.mark.parametrize("argv", [["--pp-stages", "2"],
                                  ["--pp-stages", "2", "--mesh-model", "4"],
                                  ["--pp-stages", "4", "--mesh-data", "2"]])
def test_cli_pp_stages_sizes_the_model_axis(monkeypatch, argv):
    """glow --pp-stages N sets pp_stages and, when --mesh-model is unset,
    a model axis of N, as JAX's CLI does."""
    seen = {}
    monkeypatch.setattr(L, "run_glow", lambda cfg, **kw: seen.update(
        port=cfg))
    monkeypatch.setattr(JL, "run_glow", lambda cfg, **kw: seen.update(
        jax=cfg))
    cli.main(["glow", "--device", "cpu"] + argv)
    jax_cli.main(["glow"] + argv)
    assert seen["port"].pp_stages == seen["jax"].pp_stages
    assert dataclasses.asdict(seen["port"].run.mesh) == \
        dataclasses.asdict(seen["jax"].run.mesh)
    assert seen["port"].pp_microbatches == seen["jax"].pp_microbatches


@pytest.mark.parametrize("kw", [{}, dict(pp_stages=2, pp_microbatches=4)])
def test_pp_config_fields_equal_jax(kw):
    """GlowConfig's pipeline fields: JAX's defaults and values."""
    port, ref = PC.GlowConfig(**kw), JC.GlowConfig(**kw)
    assert (port.pp_stages, port.pp_microbatches) == \
        (ref.pp_stages, ref.pp_microbatches)


@pytest.mark.parametrize("kw", [dict(pp_stages=4),
                                dict(pp_stages=2, n_flows=3)],
                         ids=["stages", "flows"])
def test_pp_refusals_match_jax(tmp_path, monkeypatch, kw):
    """A stage count other than the model axis, and flows the stages do
    not divide, raise JAX's words before any training."""
    jcfg = JC.GlowConfig(
        data=JC.DataConfig(image_size=(16, 16), batch_size=8,
                           dataset_size=16, normalize=False),
        run=JC.RunConfig(out_dir=str(tmp_path / "jax"),
                         compute_dtype="float32",
                         mesh=JC.MeshConfig(model=2)),
        **{"n_flows": 2, "n_blocks": 2, "filter_size": 16, **kw})
    with pytest.raises(ValueError) as want:
        JL.run_glow(jcfg, n_iter=1)
    monkeypatch.setattr(L, "build_mesh", lambda data, model: PM.Mesh(1, 2))
    with pytest.raises(ValueError) as got:
        L.run_glow(_glow_cfg(tmp_path / "port", MESH12, **kw), device="cpu")
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "port" / "ckpt")
