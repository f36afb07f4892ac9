"""Whole runs of each cell on the CPU at tiny sizes, past the look for a
card: sound runs come out correct, and runs with the timed path broken
underneath come out not correct, once for each fault a cell can have (a
step that leaves its state unchanged; half of each batch left out, the
mean over the rest, in every step or in the VAE-GAN's encoder and decoder
step alone; that step's gradient negated; a replayed step on a stale input slot or on repeated draws;
an answer or a prediction altered where it is produced, in every forward
or in one). The control (the reference with its bf16 operands rounded to
fp8, in the program's place) fails the cell's limits at this size too."""
import dataclasses
import time

import pytest
import torch

from portbench import faults, harness, readings

TINY = {
    "vaegan64.train": dict(image_size=64, batch_size=4, dataset_size=40,
                           ngf=8, ndf=8, latent_dim=16),
    "ddpm256.train": dict(image_size=32, batch_size=2, dataset_size=30,
                          base_ch=8, time_emb_dim=32),
    "ddpm256.sample": dict(image_size=32, base_ch=8, time_emb_dim=32),
}
TRAIN = ["vaegan64.train", "ddpm256.train"]
SEED = 2 ** 31 + 17


def tiny(name, dtype="float32"):
    cell = harness.find_cell(name)
    cell = dataclasses.replace(cell, config={**cell.config, **TINY[name],
                                             "compute_dtype": dtype})
    if cell.traffic["driver"] == "sample_ddim":
        cell = dataclasses.replace(cell, traffic={
            **cell.traffic, "images": 2, "steps": 8, "check_from": 1,
            "check_within": 3})
    return cell


def run(cell, seconds=1.0):
    out = harness.run_cell(cell, SEED, seconds, False, torch.device("cpu"),
                           time.perf_counter())
    return out, harness.result_line(cell, out, False, {}, None)[1]


@pytest.mark.parametrize("name", list(TINY))
def test_sound_run_is_correct(name):
    out, ok = run(tiny(name), 2.5)
    assert ok, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert set(out.e2e) == {m["name"] for m in
                            harness.find_cell(name).end_to_end}


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_is_caught(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    out, ok = run(tiny(name))
    assert not ok
    assert {c.name for c in out.checks if not c.ok} >= {"change_gap"}


def _failed(out):
    return {c.name for c in out.checks if not c.ok}


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_is_caught(name):
    cell = tiny(name)
    with faults.half_batch(cell):
        out, ok = run(cell)
    assert not ok
    assert any(n.startswith("grad_err") for n in _failed(out))


@pytest.mark.parametrize("fault", ["g_half_batch", "g_negated"])
def test_g_step_fault_is_caught(fault):
    cell = tiny("vaegan64.train")
    with faults.FAULTS[fault](cell):
        out, ok = run(cell)
    assert not ok
    assert {"grad_err_g", "replay_err_g"} <= _failed(out)
    assert "grad_err_d" not in _failed(out)


@pytest.mark.parametrize("fault", ["stale_slot", "repeated_draws"])
@pytest.mark.parametrize("name", TRAIN)
def test_replay_only_fault_is_caught(name, fault):
    cell = tiny(name)
    with faults.FAULTS[fault](cell):
        out, ok = run(cell)
    assert not ok
    failed = _failed(out)
    assert any(n.startswith("replay_err") for n in failed)
    assert not any(n.startswith("grad_err") for n in failed)
    assert ("batch_gap" in failed) == (fault == "stale_slot")


@pytest.mark.parametrize("fault, caught", [("image", "update_gap"),
                                           ("eps", "eps_gap"),
                                           ("one_forward", "eps_ratio_max")])
def test_altered_answer_is_caught(fault, caught, monkeypatch):
    cell = tiny("ddpm256.sample")
    fam = cell.module("families")
    sampler = fam.sampler

    def broken(*args):
        request, unet = sampler(*args)
        if fault == "eps":
            unet.register_forward_hook(lambda m, a, out: out * 1.5)
            return request, unet
        if fault == "one_forward":
            seen = [0]

            def alter(m, a, out):
                seen[0] += 1
                return out * 1.25 if seen[0] % 8 == 5 else None
            unet.register_forward_hook(alter)
            return request, unet

        def altered(*a):
            out = request(*a).clone()
            out[-1] = -out[-1]
            return out
        return altered, unet
    monkeypatch.setattr(fam, "sampler", broken)
    out, ok = run(cell, 2.5)
    assert not ok
    assert caught in _failed(out)


@pytest.mark.parametrize("name", list(TINY))
def test_control_fails_the_limits(name):
    cell = tiny(name, "bfloat16")
    drv = cell.module("drivers", cell.traffic["driver"])
    fn = readings.train_seed if name in TRAIN else readings.sample_seed
    ctx = harness.Context(cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    rows = dict(fn(ctx, True, drv))
    lim = cell.workload["limits"]
    assert any(rows["control"][k] > lim[k] for k in lim
               if k in rows["control"])
