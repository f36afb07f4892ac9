"""The Glow cell, ``glow64-stack.train``: the plain reference against the
program's K6 path (its plain CPU form) at a tiny size in f32; whole tiny
runs on the CPU, sound ones correct and each of ``faults_glow``'s faults,
a state left unchanged and the control (the reference with its bf16
operands rounded to fp8) not; the model FLOPs against ``FlopCounterMode``
of the reference and K6's operations against the flows' share of them; the
traced run's per-layer readers; and, on a card, the control and the faults
failing the limits at the cell's own size while the program passes them.
"""
import dataclasses
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import faults_glow, harness
from portbench.flops import glow as FG
from portbench.reference import glow as RG
from portbench.reference.ops import exact

NAME = "glow64-stack.train"
TINY = dict(image_size=16, n_flows=2, n_blocks=2, filter_size=16,
            batch_size=2, dataset_size=40)
SEED = 2 ** 31 + 17


def tiny(dtype="float32"):
    cell = harness.find_cell(NAME)
    return dataclasses.replace(cell, config={**cell.config, **TINY,
                                             "compute_dtype": dtype})


def run(cell, seconds=1.0, trace=False):
    out = harness.run_cell(cell, SEED, seconds, trace, torch.device("cpu"),
                           time.perf_counter())
    return out, harness.result_line(cell, out, trace, {}, None)


def _failed(out):
    return {c.name for c in out.checks if not c.ok}


def test_reference_matches_the_program():
    """log p, logdet, the loss, every first gradient and one Adam step of
    the program (flow_stack: K6's plain form) against the reference, from
    the same weights (non-zero ZeroConvs), batch and draws, after the
    same ActNorm init."""
    cell = tiny()
    cfg = cell.config
    p = RG.weights(cfg, torch.Generator().manual_seed(1), "cpu")
    assert all(float(p[f"block{i}.{leaf}"].abs().max()) > 0
               for i in range(2) for leaf in ("flows.coupling.zero.w",
                                              "prior.w"))
    system = cell.module("families").TrainSystem(cfg, (16, 16, 3), p, 5,
                                                 torch.device("cpu"))
    g = torch.Generator().manual_seed(2)
    b0, b1 = (torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8,
                            generator=g) for _ in range(2))
    system.init_step(b0)
    ref = {k: v.clone() for k, v in p.items()}
    rg = torch.Generator().manual_seed(5)
    stats = RG.init_actnorm(ref, b0, rg, cfg, exact)
    state = system.trainer.model.state_dict()
    for k, v in stats.items():
        assert torch.allclose(state[k], v, rtol=1e-5, atol=1e-6), k
    grads = {}
    hook = system.trainer.opt.register_step_pre_hook(
        lambda opt, a, k: grads.update(
            {n: t.grad.clone() for n, t in system.leaves().items()}))
    got = {k: float(v) for k, v in
           system.trainer.train_step(b1, system.generator).items()}
    hook.remove()
    adam = RG.Adam(cfg["lr"])
    want = RG.train_steps(ref, [b1], rg, cfg, exact, adam=adam)[0]
    for k in ("loss", "log_p", "logdet"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
    assert set(grads) == set(adam.first)
    for k, g in adam.first.items():
        assert (grads[k] - g).norm() <= 1e-4 * g.norm() + 1e-9, k
    for k, v in system.leaves().items():
        assert torch.allclose(v, ref[k], rtol=0, atol=1e-6), k


def test_sound_run_is_correct():
    out, (line, ok) = run(tiny(), 2.0)
    assert ok, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert set(out.e2e) == {m["name"] for m in
                            harness.find_cell(NAME).end_to_end}
    assert set(line["checks"]) == set(
        harness.find_cell(NAME).workload["limits"])


def test_state_left_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    out, (_, ok) = run(tiny())
    assert not ok
    assert {"change_gap", "step_err"} <= _failed(out)


@pytest.mark.parametrize("fault, caught", [
    ("logdet_dropped", {"logdet_gap", "grad_err_norm", "step_err"}),
    ("half_batch", {"grad_err_coupling", "grad_err_norm", "grad_err_prior",
                    "step_err"}),
    ("repeated_draws", {"draw_gap"}),
    ("stale_slot", {"batch_gap", "step_err"})])
def test_fault_is_caught(fault, caught):
    cell = tiny()
    with faults_glow.FAULTS[fault](cell):
        out, (_, ok) = run(cell)
    assert not ok
    failed = _failed(out)
    assert caught <= failed, failed
    if fault in ("repeated_draws", "stale_slot"):
        # the first step is sound: only a later step's inputs are wrong
        assert not any(n.startswith("grad_err") for n in failed)


def test_control_fails_the_limits():
    cell = tiny("bfloat16")
    drv = cell.module("drivers", cell.traffic["driver"])
    ctx = harness.Context(cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    rows = dict(drv.readings(ctx, True))
    lim = cell.workload["limits"]
    assert all(rows["program"][k] <= lim[k] for k in lim), rows["program"]
    assert any(rows["control"][k] > lim[k] for k in lim)


def test_a_program_without_the_loop_fails_before_set_up(monkeypatch):
    """An older program (no ``_glow_steps``) fails at once, not after
    making the rows."""
    from vgd_tpu_torch.train import loop
    monkeypatch.delattr(loop, "_glow_steps")
    drv = tiny().module("drivers", "train_stream")
    monkeypatch.setattr(drv, "Run", None)
    with pytest.raises(ImportError):
        run(tiny())


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc


def test_forward_flops_at_64():
    cfg = dict(harness.find_cell(NAME).config, batch_size=1)
    p = {k: v.to("meta") for k, v in RG.weights(
        dict(cfg, n_flows=1), torch.Generator(), "cpu").items()}
    # the meta leaves with the cell's K: shapes only
    p = {k: (v.expand((cfg["n_flows"],) + v.shape[1:])
             if ".flows." in k else v) for k, v in p.items()}
    x = torch.empty(1, 64, 64, 3, device="meta")
    with torch.no_grad():
        fc = _count(lambda: RG.forward(p, x, cfg))
    assert fc.get_total_flops() == FG.forward_flops(cfg, 1)
    per_image, _, _, _ = FG.forward_terms(cfg)
    assert per_image / 1e9 == pytest.approx(29.658824704, rel=1e-12)


def test_step_flops():
    cfg = dict(tiny().config, batch_size=2)
    p = RG.weights(cfg, torch.Generator().manual_seed(3), "cpu")
    b = [torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8)]
    fc = _count(lambda: RG.train_steps(p, b, torch.Generator(), cfg, exact))
    assert fc.get_total_flops() == FG.step_flops(cfg)


def test_k6_operations_are_the_flows_share():
    """K6's forward operations over a step are the forward's FLOPs less the
    priors and the PLU products; the backward three times that; 8
    launches."""
    cell = harness.find_cell(NAME)
    cfg, b = cell.config, cell.config["batch_size"]
    k6 = cell.module("kernels", "k6")
    table = k6.launches(cfg, b)
    assert len(table) == 2 * cfg["n_blocks"]
    assert all(dt == "bf16" for _, _, dt in table)
    fwd = sum(ops for ops, _, _ in table[::2])
    assert [ops for ops, _, _ in table[1::2]] == [
        3 * ops for ops, _, _ in table[::2]]
    priors = sum(2 * side * side * 9 * (c // 2 * c if split else 2 * c * c)
                 for c, side, split in FG.blocks(cfg))
    per_image, per_forward, _, _ = FG.forward_terms(cfg)
    assert fwd == b * (per_image - priors)
    assert FG.forward_flops(cfg, b) == fwd + b * priors + per_forward
    assert k6.launches(dict(cfg, flow_stack=False), b) == []
    assert len(k6.launches(dict(cfg, flow_stack=64), b)) == 4
    assert k6.PATTERN.search("void tc::flow_stack_bwd<true>(Args)")


def test_traced_run_reports_the_glow_readers():
    """On the CPU the host step counter and the staging's counters read;
    the device readers need a card's peaks and the step's kernels."""
    from vgd_tpu_torch.utils import trace
    trace.COUNTERS.clear()
    cell = dataclasses.replace(tiny(), workload={**tiny().workload,
                                                 "trace_steps": 2})
    out, (line, ok) = run(cell, 1.0, trace=True)
    assert ok and out.timeline.units == {"step": 2}
    assert trace.COUNTERS["glow.steps"] == 3 + out.attempted
    assert trace.COUNTERS["glow.init_s"] > 0
    m = line["metrics"]
    for name in ("glow_step_host_ms.train", "stage_busy_ms.train",
                 "stage_wait_ms.train"):
        assert m[name]["value"] > 0, name
    assert "roofline.k6" not in m and "mfu.train" not in m
    assert {x["name"] for x in cell.per_layer} >= {
        "roofline.k6", "glow_step_host_ms.train", "mfu.train",
        "kernels_per_step.train", "device_idle.train"}


def test_no_jax_is_loaded():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "c = harness.find_cell(%r)\n"
        "c.module('drivers', c.traffic['driver']); c.module('families')\n"
        "c.module('reference'); c.module('flops'); c.module('kernels', 'k6')\n"
        "import portbench.readings_glow, portbench.faults_glow\n"
        "print(harness.forbidden_modules())\n" % (harness.ROOT, NAME))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip().splitlines()[-1] == "[]"
    src = open(os.path.join(harness.BENCH, "reference", "glow.py")).read()
    assert "vgd_tpu" not in src and "import jax" not in src


@pytest.mark.gpu
def test_control_and_faults_fail_and_program_passes_at_cell_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.find_cell(NAME)
    drv = cell.module("drivers", cell.traffic["driver"])
    lim = cell.workload["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        ctx = harness.Context(cell, seed, 0.0, False,
                              torch.device("cuda", 0), time.perf_counter())
        rows = dict(drv.readings(ctx, True, faults_glow.FAULTS))
        assert all(rows["program"][k] <= lim[k] for k in lim), rows
        assert any(rows["control"][k] > lim[k] for k in lim), rows
        for name in faults_glow.FAULTS:
            fault = rows["fault_" + name]
            assert "error" in fault or any(
                fault[k] > lim[k] for k in lim), rows
