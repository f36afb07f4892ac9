"""``BENCHMARK.json`` against the benchmark's contract, the result line's
keys, and the check that no run loads JAX or the JAX package."""
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.timeline import reduce

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 and 1 <= cells <= 24


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metrics(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))
        for cell in m["workloads"]:
            # every cell of a per-layer metric reports what it moves
            assert m["moves"] in [e["name"] for e in
                                  harness.find_cell(cell).end_to_end]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    cell = harness.find_cell(w["name"])
    assert w["chips"] == 1
    names = [e["name"] for e in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert conf["file"].startswith("portbench/")
    assert conf["reduced"] == cell.config["reduced"]
    for kind in ("drivers", "families", "reference", "flops"):
        name = cell.traffic["driver"] if kind == "drivers" else None
        assert cell.module(kind, name) is not None


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_result_line_keys():
    cell = harness.find_cell("ddpm256.sample")
    out = harness.Outcome(attempted=3, failed=0,
                          e2e={"sample_images_per_s": 1.5, "peak_mem_gb": 2.0,
                               "setup_s": 9.0},
                          checks=[harness.Check("eps_gap", 0.01, 0.05)],
                          memory_peak_bytes=2_000_000_000)
    line, ok = harness.result_line(cell, out, False, {"platform": "gpu"},
                                   None)
    assert ok and list(line) == ["correct", "attempted", "failed", "metrics",
                                 "device", "checks"]
    assert set(line["metrics"]) == {"sample_images_per_s", "peak_mem_gb",
                                    "setup_s"}
    events = [{"ph": "X", "cat": "user_annotation", "name":
               "portbench.window", "ts": 0.0, "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel<256>",
               "ts": 5.0, "dur": 20.0},
              {"ph": "X", "cat": "kernel", "name": "groupnorm_silu_kernel",
               "ts": 25.0, "dur": 15.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": 40.0, "dur": 60.0}]
    out.timeline = reduce(events, {"forward": 1, "request": 1})
    assert out.timeline.busy_s == pytest.approx(35e-6)
    line, _ = harness.result_line(cell, out, True, {"platform": "gpu"},
                                  harness.peaks_of("NVIDIA H100 80GB HBM3"))
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert line["device"]["window_s"] == pytest.approx(100e-6)
    assert [g[0] for g in line["breakdown"]["idle_gaps"]] == [
        "aten::copy_ (x1)", "device gaps under 10 us (launch latency) (x1)"]
    assert {"roofline.k3", "roofline.k4", "device_idle.sample"} <= set(
        line["metrics"])
    line["checks"]["eps_gap"]["value"] = 0.5
    out.checks[0].value = 0.5
    assert not harness.result_line(cell, out, False, {}, None)[1]


def test_no_jax_is_loaded():
    """The harness, the drivers, the families and the program import none
    of JAX or the JAX package; a module named ``jax`` would be found."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "for w in ('vaegan64.train', 'ddpm256.train', 'ddpm256.sample'):\n"
        "    c = harness.find_cell(w)\n"
        "    c.module('drivers', c.traffic['driver']); c.module('families')\n"
        "    c.module('reference'); c.module('flops')\n"
        "import vgd_tpu_torch.train.loop, portbench.readings\n"
        "print(harness.forbidden_modules())\n"
        "sys.modules['jax.numpy'] = sys\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "['jax']"


def test_run_refuses_without_a_card():
    """With no card visible the run prints no result and exits 2."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ddpm256.sample",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and not out.stdout.strip()
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
