"""Glow's tensor parallelism in the port (``parallel/tensor_parallel.py``)
against the JAX package on the CPU, in f32, at 16x16, 2 blocks of 2 flows,
coupling width 16 (32 for JAX's own run).

The port's ranks are fresh gloo processes (``parallel.launch.spawn``; two
of them on a data=1 x model=2 mesh, four on data=2 x model=2), started in
a thread while this process runs the one-process references and JAX:

* the split axes against JAX's ``coupling_param_specs``; a full state (and
  Adam's moments) cut to each rank's shard and gathered back, exactly;
* the sharded coupling network of one flow, image and EEG kernels, against
  JAX's unsharded ``Glow._coupling_nn``: output, input gradient and every
  parameter gradient (the shards put back together) within 1e-5 of the
  largest magnitude, and the replicated results bit-equal on both ranks;
* ``run_glow`` at data=1 x model=2 and data=2 x model=2, and
  ``run_glow_eeg`` at data=1 x model=2, against one port process, held as
  ``tests/test_torch_port_parallel_loops.py`` holds data parallelism
  (losses within 1e-5 relative, parameters within 1e-4 for the elements a
  real gradient moves and 2 lr a step for the rest, the ranks' gathered
  states bit-equal after every step); each rank holds half of the
  filters, and a checkpoint is the full state;
* a TP checkpoint resumed in one process, and a one-process checkpoint
  resumed under TP;
* JAX's ``run_glow`` at ``tests/test_tp_production.py``'s configuration
  (MeshConfig(data=4, model=2), a loss logged every iteration) against the
  port on data=2 x model=2 from JAX's init and draws (the JAX state
  carried over ``io.jax_params.load_jax_glow_state``, which cuts each
  rank's shard): losses within 1e-5;
* the refusals, in JAX's words.
"""
import dataclasses
import os
import shutil
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_parallel_loops import (_close_logs, _close_metrics,
                                            _close_state, _losses, _real)

from vgd_tpu.core import config as JC
from vgd_tpu.core.rng import seed_all as jax_seed_all
from vgd_tpu.data.celeba import make_image_datasets as jax_datasets
from vgd_tpu.models import glow as JG
from vgd_tpu.parallel import mesh as JM
from vgd_tpu.parallel import tensor_parallel as JTP
from vgd_tpu.train import loop as JL
from vgd_tpu.train.glow import GlowTrainer as JT
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.models import glow as PG
from vgd_tpu_torch.parallel import mesh as PM
from vgd_tpu_torch.parallel import tensor_parallel as TP
from vgd_tpu_torch.parallel import workers
from vgd_tpu_torch.parallel.launch import spawn
from vgd_tpu_torch.train import loop as L

REL = 1e-5
E = 2                    # iterations before the resume
F = 16
MESH12, MESH22 = PC.MeshConfig(data=1, model=2), PC.MeshConfig(data=2,
                                                               model=2)
LEAVES = [(n, leaf) for n, d in TP.coupling_param_specs().items()
          for leaf in d]


def _glow_cfg(out, mesh=PC.MeshConfig(), **kw):
    return PC.GlowConfig(
        data=PC.DataConfig(image_size=(16, 16), batch_size=8,
                           dataset_size=24, normalize=False),
        run=PC.RunConfig(out_dir=str(out), compute_dtype="float32",
                         sample_every_iters=2, checkpoint_every_iters=2,
                         mesh=mesh),
        **{"n_flows": 2, "n_blocks": 2, "filter_size": F, **kw})


def _eeg_cfg(out, mesh=PC.MeshConfig()):
    return PC.GlowEEGConfig(
        run=PC.RunConfig(out_dir=str(out), compute_dtype="float32",
                         sample_every_iters=2, checkpoint_every_iters=2,
                         mesh=mesh),
        batch_size=8, n_flows=2, n_blocks=2, filter_size=F)


def _loop(family, cfg, n_iter, resume=False):
    return dict(family=family, cfg=cfg, n_iter=n_iter, resume=resume)


# ------------------------------------------------------------ JAX's pieces
COUPLINGS = {"image": dict(in_channels=3, variant="image", x=(4, 8, 8, 6)),
             "eeg": dict(in_channels=4, variant="eeg", x=(4, 8, 1, 4))}


def _coupling_case(name, seed):
    """A perturbed JAX init of one flow's coupling leaves, its input, the
    output cotangent, and JAX's output and gradients."""
    c = COUPLINGS[name]
    jm = JG.Glow(in_channels=c["in_channels"], n_flows=1, n_blocks=1,
                 variant=c["variant"], filter_size=F)
    flows = jm.init(jax.random.key(seed))["block0"]["flows"]["coupling"]
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a[0]) + 0.1 * rng.normal(
        size=a.shape[1:]).astype(np.float32), flows)
    x = rng.normal(size=c["x"]).astype(np.float32)
    gy = rng.normal(size=c["x"]).astype(np.float32)

    def f(pp, xx):
        out = jm._coupling_nn(pp, xx)
        return jnp.sum(out * gy), out
    (_, y), (dp, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x))
    port = {"kw": dict(in_channels=c["in_channels"], n_flows=1, n_blocks=1,
                       variant=c["variant"], filter_size=F),
            "p": {n: {k: torch.from_numpy(v) for k, v in d.items()}
                  for n, d in p.items()},
            "x": torch.from_numpy(x), "gy": torch.from_numpy(gy)}
    return port, {"y": np.asarray(y), "dx": np.asarray(dx),
                  **{f"{n}.{k}": np.asarray(v) for n, d in dp.items()
                     for k, v in d.items()}}


def _roundtrip_case():
    """A port Glow's full state and an Adam state with non-zero moments."""
    model = PG.Glow(in_channels=3, n_flows=2, n_blocks=2, filter_size=F)
    model.init_parameters(torch.Generator().manual_seed(3))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.randn(p.shape)
    opt.step()
    return {"params": {k: v.detach().clone() for k, v in
                       model.state_dict().items()},
            "opt": opt.state_dict(), "filter_size": F,
            "names": [k for k, _ in model.named_parameters()]}


def _tp_production_cfg(out):
    """tests/test_tp_production.py's Glow run, a loss logged every
    iteration."""
    return JC.GlowConfig(
        data=JC.DataConfig(image_size=(16, 16), batch_size=8,
                           dataset_size=16, normalize=False),
        run=JC.RunConfig(out_dir=str(out), compute_dtype="float32",
                         sample_every_iters=1, checkpoint_every_iters=100,
                         mesh=JC.MeshConfig(data=4, model=2)),
        n_flows=2, n_blocks=2, filter_size=32, n_iter=3)


def _jax_run_inputs(jcfg):
    """What JAX's run_glow starts from: its init state, its batches (init
    batch first) and its U(0, 1) draws, rebuilt outside the run."""
    key = jax_seed_all(jcfg.run.seed, impl=jcfg.run.prng_impl)
    train, _, shape = jax_datasets(jcfg.data, seed=jcfg.run.seed)
    it = iter(train)
    batches = [next(it) for _ in range(jcfg.n_iter + 1)]
    state = jax.device_get(JT(jcfg, shape).init(key))
    count, mu, nu = state.opt_state[0]
    state = types.SimpleNamespace(
        params=state.params, step=state.step,
        opt_state={"count": count, "mu": mu, "nu": nu})
    keys = [key] + [jax.random.fold_in(key, i) for i in range(jcfg.n_iter)]
    noises = [torch.from_numpy(np.array(jax.random.uniform(
        k, batches[0].shape))) for k in keys]
    return state, [torch.from_numpy(b) for b in batches], noises, shape


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tp")
    # the one-process references the ranks resume from come first
    ref = workers.train_loop(**_loop("glow", _glow_cfg(root / "ref"), E + 1))
    shutil.copytree(root / "ref", root / "tpres")
    ck = Checkpointer(str(root / "tpres" / "ckpt"))
    for s in ck.all_steps():
        if s > E:
            os.remove(ck._path(s))
    couplings = [_coupling_case(name, i) for i, name in
                 enumerate(COUPLINGS)]
    roundtrip = _roundtrip_case()
    jcfg = _tp_production_cfg(root / "jax")
    state, batches, noises, shape = _jax_run_inputs(jcfg)
    pcfg = PC.GlowConfig(
        data=PC.DataConfig(image_size=(16, 16), batch_size=8,
                           normalize=False),
        run=PC.RunConfig(compute_dtype="float32", mesh=MESH22),
        n_flows=2, n_blocks=2, filter_size=32)
    two = [("mp_checks", dict(inp={"mesh": (1, 2),
                                   "tp": [c for c, _ in couplings],
                                   "roundtrip": roundtrip})),
           ("train_loops", dict(jobs=[
               _loop("glow", _glow_cfg(root / "tp12", MESH12), E),
               _loop("glow", _glow_cfg(root / "tpres", MESH12), E + 1,
                     resume=True),
               _loop("glow-eeg", _eeg_cfg(root / "eeg12", MESH12), 3)]))]
    four = [("train_loops", dict(jobs=[
        _loop("glow", _glow_cfg(root / "tp22", MESH22), E)])),
        ("glow_steps", dict(cfg=pcfg, img_shape=shape, state=state,
                            batches=batches, noises=noises))]
    parts = {}

    def ranks():
        try:
            parts[2] = spawn("vgd_tpu_torch.parallel.workers:bodies", 2,
                             two, timeout=600)
            parts[4] = spawn("vgd_tpu_torch.parallel.workers:bodies", 4,
                             four, timeout=600)
        except Exception as e:  # noqa: BLE001 - raised below
            parts["error"] = e
    thread = threading.Thread(target=ranks)
    thread.start()
    ref_eeg = workers.train_loop(**_loop("glow-eeg", _eeg_cfg(
        root / "ref-eeg"), 3))
    jax_log = JL.run_glow(jcfg, n_iter=jcfg.n_iter)["log"]
    thread.join()
    if "error" in parts:
        raise parts["error"]
    one_resume = workers.train_loop(**_loop("glow", _glow_cfg(
        root / "tp12"), E + 1, resume=True))
    mp = [p[0] for p in parts[2]]
    tp12, tpres, eeg12 = zip(*[p[1] for p in parts[2]])
    tp22 = [p[0][0] for p in parts[4]]
    return dict(root=root, ref=ref, ref_eeg=ref_eeg, mp=mp,
                couplings=[w for _, w in couplings], roundtrip=roundtrip,
                tp={"tp12": list(tp12), "tp22": tp22, "eeg12": list(eeg12)},
                tpres=list(tpres), one_resume=one_resume,
                jax_log=jax_log, port_steps=[p[1] for p in parts[4]])


# ------------------------------------------------------ layout and collectives
@pytest.mark.parametrize("conv,leaf", LEAVES)
def test_split_axes_match_jax(conv, leaf):
    """The port splits each coupling leaf on the axis JAX's PartitionSpec
    gives the model axis (stacked HWIO layout), and nothing else."""
    spec = JTP.coupling_param_specs()[conv][leaf]
    want = spec.index(JM.MODEL_AXIS) if JM.MODEL_AXIS in spec else None
    assert TP.split_axis(f"block1.flows.coupling.{conv}.{leaf}") == want
    assert TP.split_axis(f"block1.prior.{leaf}") is None
    assert TP.split_axis(f"block1.flows.actnorm.{leaf}") is None


def test_shard_gather_round_trip(runs):
    """A full state and its Adam moments cut to each rank's shard, then
    gathered from both: exactly the full state again; each shard is its
    rank's slice."""
    rt = runs["roundtrip"]
    for m, part in enumerate(runs["mp"]):
        got = part["roundtrip"]
        for k, v in rt["params"].items():
            assert torch.equal(got["full"][k], v), k
            axis = TP.split_axis(k)
            want = v if axis is None else v.narrow(
                axis, m * v.shape[axis] // 2, v.shape[axis] // 2)
            assert torch.equal(got["shard"][k], want), k
        for i, st in rt["opt"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got["full_opt"]["state"][i][key],
                                   st[key]), (i, key)


@pytest.mark.parametrize("case", range(len(COUPLINGS)), ids=list(COUPLINGS))
def test_tp_coupling_matches_jax(runs, case):
    """The sharded coupling network on 2 ranks against JAX's unsharded one:
    output, dx and every parameter gradient within 1e-5 of the largest
    magnitude; output, dx and the replicated leaves' gradients bit-equal
    on both ranks."""
    want = runs["couplings"][case]
    got = [p["tp"][case] for p in runs["mp"]]
    for key, w in want.items():
        axis = TP.split_axis(f"coupling.{key}")
        if axis is None:
            g = got[0][key]
            assert torch.equal(g, got[1][key]), key
        else:   # one flow: the stacked axis less one
            g = torch.cat([p[key] for p in got], dim=axis - 1)
        err = float((g - torch.from_numpy(w)).abs().max())
        assert err <= REL * float(np.abs(w).max()) + 1e-12, (key, err)


# --------------------------------------------------------------- the loops
@pytest.mark.parametrize("tag", ["tp12", "tp22", "eeg12"])
def test_tp_losses_match_one_process(runs, tag):
    """Every step's global losses and every logged loss of the TP run
    against one process's."""
    ref = runs["ref_eeg"] if tag.startswith("eeg") else runs["ref"]
    for r in runs["tp"][tag]:
        n = len(r["steps"])
        _close_metrics(_losses(r), _losses(ref)[:n], REL, tag)
        _close_logs(r["log"], ref["log"][:len(r["log"])], REL, tag)


@pytest.mark.parametrize("tag", ["tp12", "tp22", "eeg12"])
def test_tp_ranks_agree_and_hold_their_shard(runs, tag):
    """All ranks' gathered states bit-equal after every step and at the
    end, and each rank holds F / 2 filters of every split leaf."""
    res = runs["tp"][tag]
    fps = [[r["fingerprint"] for r in p["steps"]] for p in res]
    assert all(f == fps[0] for f in fps)
    assert len({p["fingerprint"] for p in res}) == 1
    for p in res:
        shapes = p["local_shapes"]
        assert shapes["block0.flows.coupling.conv1.w"][-1] == F // 2
        assert shapes["block1.flows.coupling.conv1.b"][-1] == F // 2
        assert shapes["block0.flows.coupling.conv2.w"][-2:] == (F // 2, F)
        assert shapes["block1.flows.coupling.zero.w"][3] == F // 2
        assert shapes["block0.flows.coupling.conv2.b"][-1] == F


@pytest.mark.parametrize("tag", ["tp12", "tp22", "eeg12"])
def test_tp_state_matches_one_process(runs, tag):
    """The TP run's gathered state against the one-process checkpoint at
    the same iteration, and its own checkpoint holds exactly that full
    state and Adam state."""
    eeg = tag.startswith("eeg")
    ref_dir = runs["root"] / ("ref-eeg/ckpt_mi" if eeg else "ref/ckpt")
    res = runs["tp"][tag][0]
    at = res["opt_step"]
    ref = Checkpointer(str(ref_dir)).load(at)
    keys = runs["ref_eeg" if eeg else "ref"]["adam_keys"]
    _close_state(res["state"], ref["params"], tag, _real(ref, keys))
    own = Checkpointer(str(runs["root"] / tag /
                           ("ckpt_mi" if eeg else "ckpt"))).load(at)
    assert all(torch.equal(own["params"][k], v)
               for k, v in res["state"].items())
    assert own["opt_step"] == at
    for i, st in own["opt_state"]["state"].items():
        assert st["exp_avg"].shape == ref["opt_state"]["state"][i][
            "exp_avg"].shape


def test_tp_resume_across_world_sizes(runs):
    """One process resumes the TP checkpoint and 2 TP ranks resume the
    one-process checkpoint: each continues as the one-process run did."""
    ref = runs["ref"]
    real = _real(Checkpointer(str(runs["root"] / "ref" / "ckpt")).load(),
                 ref["adam_keys"])
    for what, res in (("one-resume", runs["one_resume"]),
                      ("tp-resume", runs["tpres"][0])):
        _close_metrics(_losses(res), _losses(ref)[E:], REL, what)
        _close_state(res["state"], ref["state"], what, real)
        assert res["opt_step"] == ref["opt_step"]
    a, b = runs["tpres"]
    assert a["fingerprint"] == b["fingerprint"]


def test_tp_run_matches_jax_run_glow(runs):
    """JAX's run_glow on its data=4 x model=2 mesh against the port's TP
    trainer on data=2 x model=2 from the same init, batches and draws:
    every iteration's loss, log_p and logdet within 1e-5 relative; the
    four ranks end bit-equal."""
    want = runs["jax_log"]
    for part in runs["port_steps"]:
        got = part["losses"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("loss", "log_p", "logdet"):
                np.testing.assert_allclose(g[k], w[k], rtol=REL, atol=1e-7,
                                           err_msg=k)
    assert len({p["fingerprint"] for p in runs["port_steps"]}) == 1


# ------------------------------------------------------------- refusals
def _jax_error(out, **kw):
    """JAX's run_glow refusal for a model axis of 2 with ``kw``."""
    cfg = JC.GlowConfig(
        data=JC.DataConfig(image_size=(16, 16), batch_size=8,
                           dataset_size=16, normalize=False),
        run=JC.RunConfig(out_dir=str(out), compute_dtype="float32",
                         mesh=JC.MeshConfig(data=4, model=2)),
        n_flows=2, n_blocks=2, filter_size=kw.pop("filter_size", 32), **kw)
    with pytest.raises(ValueError) as e:
        JL.run_glow(cfg, n_iter=1)
    return str(e.value)


@pytest.mark.parametrize("case", ["fused_coupling", "flow_stack", "filter"])
def test_refusals_match_jax(tmp_path, monkeypatch, case):
    """A model axis with a coupling kernel, and filters the model axis does
    not divide, raise JAX's words before any training, on both
    families where they apply."""
    kw = {"filter": dict(filter_size=15)}.get(case, {case: True})
    want = _jax_error(tmp_path / "jax", **dict(kw))
    monkeypatch.setattr(L, "build_mesh", lambda data, model: PM.Mesh(1, 2))
    cfg = _glow_cfg(tmp_path, MESH12, **kw)
    with pytest.raises(ValueError) as got:
        L.run_glow(cfg, device="cpu")
    if case == "filter":
        assert str(got.value) == want
        with pytest.raises(ValueError) as got:
            L.run_glow_eeg(dataclasses.replace(_eeg_cfg(tmp_path, MESH12),
                                               filter_size=15),
                           device="cpu")
        assert str(got.value) == want
    else:
        head = want.split(":")[0]
        assert head == "--mesh-model > 1 is incompatible with " \
            "--fused-coupling/--flow-stack"
        assert str(got.value).startswith(head)
    assert not os.path.exists(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="not divisible by the model axis"):
        TP.shard_glow_state({}, None, [], 30, 0, 4)
