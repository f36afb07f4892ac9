"""On a card, at each cell's own size: the control (the reference with its
bf16 operands rounded to fp8, in the program's place) and each fault the
cell can have (``readings``) fail the cell's limits on three seeds, and
the program passes them on the same seeds.
``python -m pytest portbench/tests -m gpu`` on the H100; skipped without a
card."""
import time

import pytest
import torch

from portbench import harness, readings

CELLS = ["vaegan64.train", "ddpm256.train", "ddpm256.sample"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_at_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.find_cell(name)
    drv = cell.module("drivers", cell.traffic["driver"])
    fn = readings.sample_seed if name == "ddpm256.sample" else \
        readings.train_seed
    lim = cell.workload["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        ctx = harness.Context(cell, seed, 0.0, False,
                              torch.device("cuda", 0), time.perf_counter())
        rows = dict(fn(ctx, True, drv))
        assert all(rows["program"][k] <= lim[k] for k in lim), rows
        assert any(rows["control"][k] > lim[k] for k in lim
                   if k in rows["control"]), rows
        bad = [v for k, v in rows.items() if k.startswith("fault")]
        assert bad, rows
        for fault in bad:
            assert "error" in fault or any(
                fault[k] > lim[k] for k in lim if k in fault), rows
