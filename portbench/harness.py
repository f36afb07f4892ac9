"""The generic part of a run: find the cell's files by name, hand the
driver its context, take the per-layer metrics from their readers, check
the modules the process loaded, and print the result.

``BENCHMARK.json`` names a cell's configuration and traffic mix; the files
are ``configs/<config>.json`` (its ``file`` entry), ``traffic/<traffic>.json``
(which names ``drivers/<driver>.py``), ``workloads/<cell>.json`` (the
limits of ``correct`` and the traced steps), ``families/<family>.py``,
``reference/<family>.py`` and ``flops/<family>.py`` (the configuration's
``family``), and ``metrics/<metric>.py`` for each per-layer metric.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "vgd_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: Optional[str] = None):
    """The module in the file ``path`` (named after the file unless
    ``name`` is given), loaded once a process."""
    name = name or "portbench._by_path." + os.path.relpath(
        path, BENCH).replace(os.sep, ".")[:-3]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def seed_of(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, data, checks) of a run's
    ``--seed``."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def program_seed(seed: int) -> int:
    """The seed handed to the program (``RunConfig.seed``, the loader, the
    run's generator): below 2^31, since ``core.rng.seed_all`` seeds numpy's
    legacy generator, which takes at most 2^32 - 1."""
    return seed_of(seed, "program") % (1 << 31)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files loaded."""
    name: str
    config: dict
    traffic: dict
    workload: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def family(self) -> str:
        return self.config["family"]

    def module(self, kind: str, name: Optional[str] = None):
        """``<kind>/<name>.py`` (default: the configuration's family)."""
        return load_module(os.path.join(BENCH, kind,
                                        (name or self.family) + ".py"))


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name, load_json(os.path.join(ROOT, conf["file"])),
                load_json(os.path.join(BENCH, "traffic",
                                       w["traffic"] + ".json")),
                load_json(os.path.join(BENCH, "workloads", name + ".json")),
                int(w["chips"]), e2e, layer)


@dataclasses.dataclass
class Check:
    """A number compared with its limit: ``ok`` when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the work ``attempted`` and ``failed`` in the
    window, the end-to-end values by metric name, the checks that decide
    ``correct``, the window's peak of reserved device memory, the traced
    ``Timeline`` (``--trace 1``) and what the metric readers need besides
    (``extra``)."""
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    timeline: Any = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    """A driver's view of the run."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float

    phases: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def log(self, msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    def mark(self, phase: str) -> None:
        """Close a phase of the set-up (seconds since the last mark, or
        since the process started)."""
        now = time.perf_counter()
        done = self.t_start + sum(s for _, s in self.phases)
        self.phases.append((phase, now - done))

    def log_phases(self) -> None:
        self.log("set-up " + ", ".join(f"{p} {s:.3f} s"
                                       for p, s in self.phases))


@dataclasses.dataclass
class Reading:
    """A per-layer reader's view: the cell, the outcome, the card's peaks
    and the kernels' and FLOPs' files."""
    cell: Cell
    outcome: Outcome
    peaks: Optional[dict]

    @property
    def timeline(self):
        return self.outcome.timeline

    def kernel(self, kid: str):
        return self.cell.module("kernels", kid)

    def flops(self):
        return self.cell.module("flops")


def peaks_of(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind`` (``peaks.json``), or
    None for a card the table does not hold."""
    return load_json(os.path.join(BENCH, "peaks.json")).get(kind)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run must not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def per_layer_values(reading: Reading) -> Dict[str, float]:
    out = {}
    for m in reading.cell.per_layer:
        reader = load_module(os.path.join(BENCH, "metrics",
                                          m["name"] + ".py"))
        value = reader.read(reading)
        if value is not None:
            out[m["name"]] = value
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: dict,
                peaks: Optional[dict]) -> Tuple[dict, bool]:
    """The result object and whether the run is correct."""
    correct = bool(outcome.checks) and all(c.ok for c in outcome.checks) \
        and outcome.failed == 0
    if trace:
        values = per_layer_values(Reading(cell, outcome, peaks))
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        values = {m["name"]: outcome.e2e[m["name"]] for m in cell.end_to_end}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    line = {"correct": correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed),
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": device}
    if trace and outcome.timeline is not None:
        line["device"]["busy_s"] = outcome.timeline.busy_s
        line["device"]["window_s"] = outcome.timeline.window_s
        line["breakdown"] = outcome.timeline.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line, correct


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Outcome:
    """The cell's driver over one run (no look for a card: the tests call
    this on the CPU)."""
    driver = cell.module("drivers", cell.traffic["driver"])
    return driver.run(Context(cell, seed, seconds, trace, device, t_start))


def main(args, t_start: float) -> int:
    import torch

    cell = find_cell(args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees {seen}: no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    outcome = run_cell(cell, args.seed, float(args.seconds),
                       bool(args.trace), device, t_start)
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line, correct = result_line(cell, outcome, bool(args.trace), dev,
                                peaks_of(kind))
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] the run loaded {bad}: no result", file=sys.stderr)
        return 3
    print(f"[portbench] correct {correct} attempted {outcome.attempted} "
          f"failed {outcome.failed}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
