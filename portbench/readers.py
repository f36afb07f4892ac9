"""What the per-layer readers (``metrics/<metric>.py``) share: a kernel's
roofline share and a model's share of the card's peak over the traced
stretch, and the device's idle share. Each returns None where the run has
nothing to read (no trace, no launch of the kernel, a card without peaks),
never 0."""
from __future__ import annotations


def batch(reading) -> int:
    """Images a unit of the cell's work holds: a request's, else the
    configuration's batch."""
    cell = reading.cell
    return cell.traffic.get("images", cell.config["batch_size"])


def roofline(reading, kid: str):
    """Sum of the launches' bounds over the kernel's summed device time, in
    %: a launch's bound is max(operations / the peak of its operands'
    dtype, bytes / the memory bandwidth), from ``kernels/<kid>.py``."""
    tl, peaks = reading.timeline, reading.peaks
    if tl is None or peaks is None:
        return None
    spec = reading.kernel(kid)
    units = tl.units.get(spec.UNIT)
    launches = spec.launches(reading.cell.config, batch(reading))
    kernels = tl.kernels(spec.PATTERN)
    if not units or not launches or not kernels:
        return None
    bound = units * sum(max(ops / peaks[f"{dt}_flops"],
                            nbytes / peaks["hbm_bytes_per_s"])
                        for ops, nbytes, dt in launches)
    return 100.0 * bound / (sum(k.dur for k in kernels) / 1e6)


def mfu(reading, flops_per_unit: float, unit: str):
    """Model FLOPs of the traced units over the traced window, in % of the
    card's bf16 peak."""
    tl, peaks = reading.timeline, reading.peaks
    if tl is None or peaks is None or not tl.units.get(unit):
        return None
    return 100.0 * flops_per_unit * tl.units[unit] / tl.window_s / \
        peaks["bf16_flops"]


def idle(reading):
    """1 - the union of the device's operations over the traced window,
    in %."""
    tl = reading.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
