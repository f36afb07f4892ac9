"""The readings that the limits of ``correct`` are set from, on the card,
at each cell's own size, many seeds in one process:

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 ... \\
        [--control 4 5 6] [--out readings.jsonl]

For each ``--seeds`` seed: the program's numbers, as a run computes them
(training: set-up and the checked first steps through the timed path, no
window; sampling: the recorded requests), against the f32 reference. For
each ``--control`` seed also: the control, the reference computed with the
operands of the configuration's bf16 products rounded to fp8 and put in
the program's place, against the f32 reference; and the faults that the
cell can have. Training: each of ``faults.of(cell)`` planted in the
program. Sampling: one image of a request negated where it is produced,
and one forward's prediction made 25 % too large, both planted in the
recorded requests; its control's DDIM update is computed in bf16, the
step below the configuration's f32 update. A state left unchanged reads
``change_gap`` 1 and needs no run. One JSON line per seed and kind.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from portbench import compare, faults, harness  # noqa: E402


def _emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_seed(ctx, control: bool, drv):
    k = ctx.cell.traffic["check_steps"]
    r = drv.Run(ctx)
    r.first_steps(k)
    r.free()
    ref = drv.reference_readings(r)
    rows = [("program", drv.gaps(r, r.readings, ref))]
    if control:
        rows.append(("control", drv.gaps(
            r, drv.reference_readings(r, "float8"), ref)))
        for name in faults.of(ctx.cell):
            try:
                with faults.FAULTS[name](ctx.cell):
                    bad = drv.Run(ctx)
                    bad.first_steps(k)
                bad.free()
                rows.append(("fault_" + name,
                             drv.gaps(bad, bad.readings, ref)))
            except Exception as err:  # a fault that crashes fails its run
                rows.append(("fault_" + name, {"error": repr(err)}))
    return rows


def _served(ctx, drv, params, one_forward=None):
    """The check's requests served by the program with every forward
    recorded: (records, starting images, images). ``one_forward``: the
    position whose prediction is made 25 % too large where the UNet
    produces it (a hook ahead of the recorder's), in every request."""
    cell, dev = ctx.cell, ctx.device
    cfg, traffic = cell.config, cell.traffic
    request, unet = cell.module("families").sampler(
        cfg, params, harness.program_seed(ctx.seed), dev)
    reqs = drv.check_plan(traffic, ctx.seed)
    s = cfg["image_size"]
    rec = drv.Recorder(len(reqs), traffic["steps"], (traffic["images"], s, s,
                                                     cfg["channels"]), dev)
    hooks = []
    if one_forward is not None:
        seen = [0]

        def alter(module, args, out):
            seen[0] += 1
            if (seen[0] - 1) % traffic["steps"] == one_forward:
                return out * 1.25
            return None
        hooks.append(unet.register_forward_hook(alter))
    hooks.append(unet.register_forward_hook(rec))
    starts, outs = [], []
    for i in reqs:
        x_t = drv.x_start(cfg, traffic["images"], ctx.seed, i, dev)
        rec.arm()
        outs.append(request(x_t, traffic["steps"], traffic["eta"]))
        rec.disarm()
        starts.append(x_t.cpu())
    for h in hooks:
        h.remove()
    del request, unet
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec.records(), starts, outs


def sample_seed(ctx, control: bool, drv):
    cell = ctx.cell
    params = drv.make_weights(cell.module("reference"), cell.config,
                              ctx.seed, ctx.device)
    records, starts, outs = _served(ctx, drv, params)
    rows = [("program", drv.readings(ctx, params, records, starts, outs))]
    if control:
        rows.append(("control", {
            **drv.readings(ctx, params, records, starts, outs, "float8"),
            "update_gap": _control_update(ctx, records)}))
        bad = [o.clone() for o in outs]
        for o in bad:
            o[-1] = -o[-1]
        rows.append(("fault_altered_image", drv.readings(
            ctx, params, records, starts, bad)))
        del records
        one = _served(ctx, drv, params, cell.traffic["steps"] // 2)
        rows.append(("fault_one_forward", drv.readings(ctx, params, *one)))
    for _, vals in rows:
        vals.pop("eps_each", None)
    return rows


def _control_update(ctx, records):
    """Worst update gap of the DDIM update computed in bf16 (the control's
    step below the configuration's f32 update) against the next recorded
    input."""
    cfg, steps = ctx.cell.config, ctx.cell.traffic["steps"]
    ref = ctx.cell.module("reference")
    taus = ref.ddim_timesteps(cfg["timesteps"], steps)
    acp = ref.alphas_cumprod(cfg, "cpu").double().tolist() + [1.0]
    drv = ctx.cell.module("drivers", ctx.cell.traffic["driver"])
    worst = 0.0
    for rec in records:
        for p, (x, _, eps) in rec.items():
            if p + 1 in rec:
                got = drv.ddim_update(x.bfloat16(), eps.bfloat16(),
                                      acp[taus[p]], acp[taus[p + 1]])
                worst = max(worst, compare.relative(rec[p + 1][0], got))
    return worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = harness.find_cell(args.workload)
    dev = torch.device("cuda", 0)
    drv = cell.module("drivers", cell.traffic["driver"])
    run = train_seed if cell.traffic["driver"] == "train_scan" else \
        sample_seed
    for seed in args.seeds + [s for s in args.control
                              if s not in args.seeds]:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, 0.0, False, dev, t0)
        for kind, vals in run(ctx, seed in args.control, drv):
            _emit(args.out, {"workload": cell.name, "seed": seed,
                             "kind": kind, **vals,
                             "s": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
