"""Per-rank bodies of the parallel layer's checks, run by
``launch.spawn`` in each rank process (the CPU tests on gloo ranks,
``chip_smoke.py`` on the card) and, for the one-process references, in
the caller's own process.

* ``op_checks``: K1's path (``ops.fused_conv.conv_bn_lrelu``) and
  ``BatchNorm`` with global statistics, the Glow ActNorm init, and ring
  attention, on this rank's rows / tokens of global inputs;
* ``vaegan_step``: one VAE-GAN step from a given state and given draws;
* ``mp_checks``: Glow's model-parallel pieces on a model group of the
  world: the sharded coupling network (``tensor_parallel.tp_coupling_nn``)
  and the pipelined flow stack (``pipeline_parallel.pp_flow_stack``),
  forward and gradients, and ``pp_train_step``;
* ``glow_steps``: a Glow trainer on the mesh of its config, loaded from a
  JAX state, stepped through given batches and draws;
* ``bodies``: several of these in one spawn;
* ``train_loops``: whole ``run_*`` loops, each step's global losses and a
  fingerprint of the state after it (``fingerprint``: an exact integer
  function of every parameter's and buffer's bits, so two ranks agree on
  it only if their states are bit-equal; a Glow trainer's full state,
  gathered from its model group under tensor parallelism), the kernel
  launches, and the final state;
* ``scan_refusal``: the epoch scan under a host-staged (gloo) group.

Gradients of a local tensor follow the trainers' convention: each rank's
loss estimates the global one (a sum over the batch is this rank's sum
times the data axis), parameter gradients are averaged over the data axis,
and a rank's input gradient is the data axis times its share of the
global one.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from vgd_tpu_torch.parallel.collectives import average_grads
from vgd_tpu_torch.parallel.launch import init_distributed, rank_device
from vgd_tpu_torch.parallel.mesh import build_mesh


def fingerprint(tensors) -> int:
    """An exact integer of the tensors' bits (order-sensitive): equal for
    bit-equal states, and for two states that differ almost never."""
    total = 0
    for i, t in enumerate(tensors):
        t = t.detach().contiguous().reshape(-1)
        if t.is_floating_point():
            bits = t.view({8: torch.int64, 4: torch.int32,
                           2: torch.int16}[t.element_size()])
        else:
            bits = t
        w = torch.arange(bits.numel(), device=bits.device) % 1009 + 1 + i
        total += int((bits.to(torch.int64) * w).sum())
    return total


def _local_state(trainer) -> Dict[str, torch.Tensor]:
    if hasattr(trainer, "state_dict"):
        return trainer.state_dict()
    return trainer.model.state_dict()


def _state(trainer) -> Dict[str, torch.Tensor]:
    """The trainer's full state (collective for a sharded Glow trainer)."""
    if hasattr(trainer, "checkpoint_state"):
        return trainer.checkpoint_state()[0]
    return _local_state(trainer)


def adam_keys(trainer) -> Dict[str, List[str]]:
    """For each of the trainer's optimizers (``""`` for a lone one), the
    state-dict keys of its parameters in the optimizer's order."""
    opts = trainer.opts if hasattr(trainer, "opts") else {"": trainer.opt}
    ptr = {t.data_ptr(): k for k, t in _local_state(trainer).items()}
    return {name: [ptr[p.data_ptr()] for p in o.param_groups[0]["params"]]
            for name, o in opts.items()}


def _start(device: str):
    init_distributed(False, device)
    return rank_device(device)


# ---------------------------------------------------------------- op checks
def op_checks(inp: Dict, device: str = "cpu") -> Dict:
    """K1's path, BatchNorm, ActNorm init (data axis = world) and ring
    attention (model axis = world) on this rank's share of ``inp``'s
    global tensors; every result is this rank's (rows of y / dx, whole
    parameter gradients after the average)."""
    from vgd_tpu_torch.models.blocks import BatchNorm
    from vgd_tpu_torch.models.glow import Glow
    from vgd_tpu_torch.ops.fused_conv import conv_bn_lrelu
    from vgd_tpu_torch.parallel.sequence_parallel import sp_self_attention
    dev = _start(device)
    out = {}
    dp = build_mesh(-1, 1)
    g = dp.data_group

    def t(name):
        return inp[name].to(dev)

    for c in inp.get("conv", []):
        c = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in c.items()}
        x = dp.rows(c["x"]).clone().requires_grad_(True)
        leaves = [c[k].clone().requires_grad_(True)
                  for k in ("w", "gamma", "beta")]
        y, mean, var = conv_bn_lrelu(x, *leaves, padding=c["padding"],
                                     slope=c["slope"], group=g)
        bn = BatchNorm(c["w"].shape[0]).to(dev)
        bn.update(mean, var)
        # sum over the batch: this rank's share times the data axis
        (dp.data * (y * dp.rows(c["gy"])).sum()).backward()
        average_grads(leaves, g)
        out.setdefault("conv", []).append({
            "y": y.detach(), "mean": mean, "var": var,
            "dx": x.grad / dp.data,
            **{f"d{k}": p.grad for k, p in zip(("w", "gamma", "beta"),
                                                leaves)},
            "running_mean": bn.running_mean, "running_var": bn.running_var})
    if "bn" in inp:
        x = dp.rows(t("bn_x")).clone().requires_grad_(True)
        bn = BatchNorm(x.shape[-1]).to(dev)
        bn.group = g
        with torch.no_grad():
            bn.weight.copy_(t("bn_gamma"))
            bn.bias.copy_(t("bn_beta"))
        y = bn(x, train=True)
        (dp.data * (y * dp.rows(t("bn_gy"))).sum()).backward()
        average_grads(bn.parameters(), g)
        out["bn"] = {"y": y.detach(), "dx": x.grad / dp.data,
                     "dgamma": bn.weight.grad, "dbeta": bn.bias.grad,
                     "running_mean": bn.running_mean,
                     "running_var": bn.running_var}
    if "glow" in inp:
        gl = inp["glow"]
        model = Glow(**gl["kw"]).to(dev)
        model.load_state_dict({k: v.to(dev) for k, v in
                               gl["state"].items()})
        model.group = g
        model.init_actnorm(dp.rows(gl["x"].to(dev)))
        out["actnorm"] = {k: v for k, v in model.state_dict().items()
                          if ".actnorm." in k}
    if "metrics" in inp:
        from vgd_tpu_torch.eval.metrics import MetricAccumulator
        acc = MetricAccumulator(feature_fn=toy_features, group=g)
        for fake, real, n_valid in inp["metrics"]:
            acc.update(dp.rows(fake), dp.rows(real),
                       n_valid=dp.valid_rows(n_valid, len(fake)))
        out["metrics"] = {k: torch.tensor(v)
                          for k, v in acc.compute().items()}
    if "ring" in inp:
        sp = build_mesh(1, dp.data)
        q, k, v = (inp["ring"][n].to(dev).clone().requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = sp_self_attention(q, k, v, sp.model_group)
        (o * inp["ring"]["go"].to(dev)).sum().backward()
        out["ring"] = {"out": o.detach(), "dq": q.grad, "dk": k.grad,
                       "dv": v.grad}
    def host(d):
        return [host(e) for e in d] if isinstance(d, list) else \
            {n: x.detach().cpu() for n, x in d.items()}
    return {k: host(d) for k, d in out.items()}


# ------------------------------------------------- Glow model parallelism
def mp_checks(inp: Dict, device: str = "cpu") -> Dict:
    """On a (data, model) mesh of the world (``inp["mesh"]``): the sharded
    coupling network of one flow on the whole of ``x`` (``"tp"``, a list of
    cases: output, dx and this rank's shard of every parameter gradient,
    from the loss sum(out * gy)); a full state cut to this rank's shard
    and gathered back (``"roundtrip"``); the pipelined flow stack on this
    rank's rows of ``x`` (``"pp"``, for each microbatch count: y, the
    logdets, dx and the flows' gradients summed over the stages, from
    sum(y * gy) + sum(logdets) on the global batch); and ``pp_train_step``
    (``"pp_train"``: the loss and the flows after the Adam step). The PLU
    buffers P and s_sign get no gradient."""
    from vgd_tpu_torch.models.glow import Glow
    from vgd_tpu_torch.parallel import pipeline_parallel as PP
    from vgd_tpu_torch.parallel import tensor_parallel as TP
    from vgd_tpu_torch.train.common import adam
    dev = _start(device)
    mesh = build_mesh(*inp["mesh"])
    group = mesh.model_group
    out = {}

    def host(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    if "tp" in inp:
        out["tp"] = []
        for c in inp["tp"]:
            glow = Glow(**c["kw"], tp_group=group)
            # one flow's leaves, stacked as K = 1 for the split axes
            full = {f"flows.coupling.{n}.{leaf}": v.to(dev)[None]
                    for n, leaves in c["p"].items()
                    for leaf, v in leaves.items()}
            shard = {k.split("coupling.")[1]: v[0].clone().requires_grad_(
                True) for k, v in TP.shard_glow_coupling(
                    full, mesh.m, mesh.model).items()}
            p = {}
            for k, v in shard.items():
                n, leaf = k.split(".")
                p.setdefault(n, {})[leaf] = v
            x = c["x"].to(dev).clone().requires_grad_(True)
            y = TP.tp_coupling_nn(glow, p, x, group)
            (y * c["gy"].to(dev)).sum().backward()
            out["tp"].append(host({"y": y, "dx": x.grad,
                                   **{k: v.grad for k, v in shard.items()}}))
    if "roundtrip" in inp:
        c = inp["roundtrip"]
        params, opt = TP.shard_glow_state(c["params"], c["opt"], c["names"],
                                          c["filter_size"], mesh.m,
                                          mesh.model)
        full, full_opt = TP.gather_glow_state(params, group, opt,
                                              c["names"])
        out["roundtrip"] = {"shard": params, "full": full,
                            "full_opt": full_opt}
    if "pp" in inp:
        c = inp["pp"]
        glow = Glow(**c["kw"], pp_group=group)
        out["pp"] = []
        for n_mb in c["microbatches"]:
            flows = _flow_leaves(c["flows"], dev)
            x = mesh.rows(c["x"].to(dev)).clone().requires_grad_(True)
            y, ld = PP.pp_flow_stack(glow, PP.nest(flows), x, n_mb, group)
            # sum over the batch: this rank's share times the data axis
            (mesh.data * (y * mesh.rows(c["gy"].to(dev))).sum()
             + ld.sum()).backward()
            grads = [flows[k] for k in flows if flows[k].grad is not None]
            PP.sum_stage_grads(grads, group)
            average_grads(grads, mesh.data_group)
            out["pp"].append(host({"y": y, "ld": ld, "dx": x.grad / mesh.data,
                                   **{k: v.grad for k, v in flows.items()
                                      if v.grad is not None}}))
    if "pp_train" in inp:
        c = inp["pp_train"]
        glow = Glow(**c["kw"], pp_group=group)
        flows = _flow_leaves(c["flows"], dev)
        opt = adam([v for v in flows.values() if v.requires_grad], c["lr"])
        loss = PP.pp_train_step(glow, flows, opt, c["x"].to(dev),
                                c["microbatches"], group)
        out["pp_train"] = host({"loss": loss, **flows})
    return out


def _flow_leaves(flows: Dict[str, torch.Tensor], dev) -> Dict:
    """Copies on ``dev`` of a block's stacked flow leaves ("actnorm.b"
    ...), each but the PLU buffers requiring a gradient."""
    return {k: v.to(dev).clone().requires_grad_(
        not k.endswith((".P", ".s_sign"))) for k, v in flows.items()}


def toy_features(images_u8: torch.Tensor):
    """A cheap stand-in for an Inception ``feature_fn`` in the metric
    checks: each image's per-channel means and their squares as features,
    a fixed projection of them as logits."""
    x = images_u8.float().mean(dim=(1, 2)) / 255.0
    feats = torch.cat([x, x * x], dim=1)
    proj = torch.arange(30, dtype=torch.float32).reshape(6, 5) / 30.0
    return feats, feats @ proj


# ------------------------------------------------------------ VAE-GAN step
def vaegan_step(cfg, img_shape, state: Dict, batch: torch.Tensor,
                draws: Dict[str, torch.Tensor], ramp: float,
                device: str = "cpu") -> Dict:
    """One VAE-GAN train step on this rank's rows, from ``state``
    (``params`` / ``opt_state`` / ``step`` of a trainer) with the global
    ``draws`` (eps, noise_real, noise_fake); returns the losses, the state
    after it and its fingerprint."""
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    dev = _start(device)
    mesh = build_mesh(-1, 1)
    tr = VAEGANTrainer(cfg, img_shape, device=dev, mesh=mesh)
    tr.init(torch.Generator(device=dev).manual_seed(0))
    tr.load({k: v.to(dev) for k, v in state["params"].items()},
            state["opt_state"], state["step"])
    m = tr.train_step(mesh.rows(batch), ramp, **draws)
    st = tr.state_dict()
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.cpu() for k, v in st.items()},
            "opt_state": tr.opt_state(),
            "fingerprint": fingerprint(st.values())}


def glow_steps(cfg, img_shape, state, batches: List[torch.Tensor],
               noises: List[torch.Tensor], device: str = "cpu") -> Dict:
    """A ``GlowTrainer`` on the mesh of ``cfg.run.mesh``, loaded from the
    JAX state ``state`` (``io.jax_params.load_jax_glow_state``), the
    ActNorm init on batches[0] and a train step on each later batch, with
    the global U(0, 1) draws ``noises``; returns each step's losses, the
    full state after the last and its fingerprint."""
    from vgd_tpu_torch.io.jax_params import load_jax_glow_state
    from vgd_tpu_torch.train.glow import GlowTrainer
    dev = _start(device)
    mesh = build_mesh(cfg.run.mesh.data, cfg.run.mesh.model)
    tr = GlowTrainer(cfg, img_shape, device=dev, mesh=mesh)
    load_jax_glow_state(tr, state)
    tr.init_step(mesh.rows(batches[0]).to(dev), noise=noises[0])
    losses = [{k: float(v) for k, v in tr.train_step(
        mesh.rows(b).to(dev), noise=n).items()}
        for b, n in zip(batches[1:], noises[1:])]
    st = _state(tr)
    return {"losses": losses, "fingerprint": fingerprint(st.values()),
            "state": {k: v.cpu() for k, v in st.items()}}


def bodies(calls: List) -> List:
    """``fn(**kwargs)`` for each (name of a function of this module,
    kwargs), in order."""
    return [globals()[name](**kw) for name, kw in calls]


# --------------------------------------------------------------- the loops
STEP_METHODS = {"diffusion": ("vgd_tpu_torch.train.diffusion",
                              "DiffusionTrainer", "train_step"),
                "vaegan": ("vgd_tpu_torch.train.vaegan", "VAEGANTrainer",
                           "train_step"),
                "vae": ("vgd_tpu_torch.train.vae", "VAETrainer",
                        "train_step"),
                "gan": ("vgd_tpu_torch.train.gan", "GANTrainer",
                        "train_step"),
                "wgan": ("vgd_tpu_torch.train.gan", "GANTrainer",
                         "train_step_wgan"),
                "glow": ("vgd_tpu_torch.train.glow", "_GlowTrainerBase",
                         "train_step"),
                "glow-eeg": ("vgd_tpu_torch.train.glow", "_GlowTrainerBase",
                             "train_step")}


@contextlib.contextmanager
def record_steps(family: str, rows: List[Dict]):
    """Inside the block each train step of ``family`` appends its global
    losses, the fingerprint of the trainer's state after it and its time
    (CUDA events on a card, else the host clock) to ``rows``."""
    import importlib
    mod, cls, name = STEP_METHODS[family]
    owner = getattr(importlib.import_module(mod), cls)
    step = getattr(owner, name)
    events = []

    def recorded(self, *args, **kwargs):
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        m = step(self, *args, **kwargs)
        if cuda:
            end.record()
        events.append((start, end) if cuda else time.perf_counter() - t0)
        ms = m if isinstance(m, dict) else {"loss": m}
        rows.append({"metrics": {k: float(v) for k, v in ms.items()},
                     "fingerprint": fingerprint(_state(self).values())})
        return m

    setattr(owner, name, recorded)
    try:
        yield rows
    finally:
        setattr(owner, name, step)
        for row, e in zip(rows, events):
            row["ms"] = (e[0].elapsed_time(e[1]) if isinstance(e, tuple)
                         else e * 1e3)


def _run(family: str):
    from vgd_tpu_torch.train import loop as L
    return {"diffusion": L.run_diffusion, "vaegan": L.run_vaegan,
            "vae": L.run_vae, "gan": L.run_gan, "wgan": L.run_gan,
            "glow": L.run_glow, "glow-eeg": L.run_glow_eeg}[family]


def train_loop(family: str, cfg, device: str = "cpu",
               forward: Optional[Dict] = None, state: bool = True,
               record: bool = True, **run_kwargs) -> Dict:
    """``run_<family>(cfg, device=device, **run_kwargs)`` on this rank:
    its log, every step's losses / fingerprint / ms (``record``; off for
    the epoch scan on a card, whose captured step cannot read its losses
    on the host), the launches of each kernel, the peak memory on a card,
    and (``state``) the final state on the CPU. ``forward`` (DDPM: ``x``
    and ``t``) also runs the sampling UNet once on them after training and
    returns its output and launches."""
    from vgd_tpu_torch.ops import kernels as K
    dev = _start(device)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rows: List[Dict] = []
    K.LAUNCHES.clear()
    with (record_steps(family, rows) if record
          else contextlib.nullcontext()):
        res = _run(family)(cfg, device=device, **run_kwargs)
    launches = dict(K.LAUNCHES)
    tr = res["trainer"]
    st = _state(tr)
    out = {"log": res["log"], "steps": rows, "launches": launches,
           "local_shapes": {k: tuple(v.shape)
                            for k, v in _local_state(tr).items()},
           "fingerprint": fingerprint(st.values()), "opt_step": tr.step,
           "adam_keys": adam_keys(tr),
           # the training UNet's forwards (DDPM: steps and validation)
           "forwards": getattr(getattr(tr, "model", None), "forwards",
                               None)}
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if state:
        out["state"] = {k: v.cpu() for k, v in st.items()}
    if forward is not None:
        K.LAUNCHES.clear()
        with torch.inference_mode():
            y = tr.model_fused(forward["x"].to(tr.device),
                               forward["t"].to(tr.device))
        out["forward"] = {"out": y.float().cpu(),
                          "launches": dict(K.LAUNCHES)}
    return out


def scan_refusal(cfg, device: str = "cpu", steps: int = 2) -> Dict:
    """The epoch scan under this rank's process group: ``run_vaegan`` with
    ``epoch_scan=True`` (over gloo on a card: refused before any step),
    then with the default (on a card over gloo: ``steps`` steps of the
    per-step loop, announced on stderr). Returns the refusal's message
    (None if it trained), the stderr line and the steps trained."""
    import io
    from vgd_tpu_torch.train import loop as L
    _start(device)
    try:
        L.run_vaegan(cfg, epochs=1, max_steps_per_epoch=steps,
                     device=device, epoch_scan=True)
        raised = None
    except ValueError as e:
        raised = str(e)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res = L.run_vaegan(cfg, epochs=1, max_steps_per_epoch=steps,
                           device=device)
    line = next((ln for ln in err.getvalue().splitlines()
                 if "epoch scan" in ln), None)
    return {"raised": raised, "default_line": line,
            "default_steps": res["trainer"].step}


def train_loops(jobs: List[Dict]) -> List[Dict]:
    """``train_loop(**job)`` for each job, in order."""
    return [train_loop(**job) for job in jobs]
