"""The numbers that decide ``correct`` in a training cell, each a gap
between the program's readings and the plain reference's over the first
``check_steps`` steps that the timed path ran, which the reference
follows from the same weights, rows and draws. A reference module's
``GROUPS`` splits the leaves by the optimizer step that updates them (the
VAE-GAN's discriminator ``_d`` and encoder + decoder ``_g``; DDPM's one
group, no suffix), and each group has its own numbers:

* ``grad_err``: the error of each leaf's first gradient as the optimizer
  got it, ||program - reference|| over ||reference|| pooled over the
  group's leaves. Step 1 is an eager step: the discriminator's first D
  step, the generator's step after the two D steps, DDPM's step;
* ``replay_err``: the error of the first replayed step, step
  ``check_steps`` (the first two steps are eager warm-up steps of the
  step graph). The reference runs that step from the program's own
  parameters, Adam moments and counts before it, on the batch and draws
  that the traffic and the run's seed give it, and the program's first
  moments after the step are held against the reference's:
  ||m_program - m_reference|| over ||m_reference - b1^n m_before||, the
  part of the moment that the step's n gradients wrote, pooled over the
  group. A leaf whose Adam count differs from the reference's reads inf.

A group in the reference's ``FORCED`` takes, in both numbers, some leaves
from the program's own state after the step (the VAE-GAN's generator step
runs against the program's discriminator after that step's D steps). The
cell's other numbers:

* ``batch_gap``: the share of bytes, in the worst checked step, in which
  the batch that step consumed (on a card, the step graph's input slot
  after the replay) differs from the rows the traffic gives it: 0 exactly;
* ``change_gap``: per leaf, the gap between the norms of the parameters'
  change over the steps, over the larger of that leaf's reference norm
  and the median leaf's, counting only the elements whose reference first
  moment after step 1 is at least ``MOVED`` times the median leaf's RMS
  first moment (a bias under a batch normalisation, or a key's bias under
  a softmax, has a gradient of rounding alone, which Adam turns into a
  full-size step of either sign); the worst leaf. It reads 1 for a state
  left unchanged;
* logged, not compared: ``loss_gap`` (every reported loss, worst over the
  steps) and ``loss_gap_step1`` (step 1 only).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, NamedTuple

import torch

MOVED = 1e-3


class Readings(NamedTuple):
    """What a run (or the reference in the program's place) gives over
    the checked steps, host tensors by leaf name: the losses of each step;
    the batch each step consumed; each leaf's first gradient; the first
    moments and the parameters after step 1; the parameters' change after
    the last step; (parameter, first moment, second moment, Adam count)
    before the last step; (parameter, first moment, Adam count) after
    it."""
    losses: List[dict]
    batches: List[torch.Tensor]
    first: Dict[str, torch.Tensor]
    moments: Dict[str, torch.Tensor]
    params1: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]
    before: Dict[str, tuple]
    after: Dict[str, tuple]


class Forced(NamedTuple):
    """The reference's last step from a run's state before it: by leaf,
    the first moment and Adam count after it, and the part of the moment
    the step wrote (m - b1^n m_before)."""
    m: Dict[str, torch.Tensor]
    t: Dict[str, int]
    wrote: Dict[str, torch.Tensor]


def loss_gap(prog: List[dict], ref: List[dict]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        for k, rv in r.items():
            pv = p[k]
            gap = abs(pv - rv) / max(abs(rv), 1e-12)
            worst = max(worst, gap if math.isfinite(pv) else math.inf)
    return worst if len(prog) == len(ref) else math.inf


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> tuple:
    """(worst gap, its leaf): |prog - ref| over the larger of the leaf's
    and the median leaf's reference value."""
    med = statistics.median(ref.values())
    worst, at = 0.0, None
    for k, r in ref.items():
        gap = abs(prog.get(k, math.nan) - r) / max(r, med, 1e-30)
        if not math.isfinite(gap):
            gap = math.inf
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def threshold(ref_moments: Dict[str, torch.Tensor]) -> float:
    """``MOVED`` times the median over leaves of the RMS of the reference's
    first moment."""
    return MOVED * statistics.median(
        float(v.double().square().mean().sqrt()) for v in ref_moments.values())


def masked_norms(deltas: Dict[str, torch.Tensor],
                 ref_moments: Dict[str, torch.Tensor],
                 floor: float) -> Dict[str, float]:
    """Norm of each leaf's change over the elements whose reference first
    moment is at least ``floor``; leaves with no such element are left
    out."""
    out = {}
    for k, m in ref_moments.items():
        keep = m.abs() >= floor
        if bool(keep.any()):
            out[k] = float(deltas[k].double()[keep].norm())
    return out


def _diff2(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
           k: str) -> float:
    if k not in a:
        return math.inf
    return float((a[k].double() - b[k].double()).norm()) ** 2


def pooled(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
           scale: Dict[str, torch.Tensor], names) -> float:
    """sqrt(sum ||a - b||^2) over sqrt(sum ||scale||^2) over ``names``."""
    num = sum(_diff2(a, b, k) for k in names)
    den = sum(float(scale[k].double().norm()) ** 2 for k in names)
    return math.sqrt(num / den) if den > 0 else math.inf


def group_names(names, groups: Dict[str, tuple]) -> Dict[str, list]:
    """The leaves of each group: those whose name starts with one of its
    prefixes."""
    return {g: [k for k in names if k.startswith(pre)]
            for g, pre in groups.items()}


def batch_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The worst step's share of bytes that differ."""
    if len(prog) != len(ref):
        return math.inf
    return max((float((p != r).double().mean()) if p.shape == r.shape
                else math.inf for p, r in zip(prog, ref)), default=0.0)


def train_gaps(prog: Readings, ref: Readings, want: dict,
               groups: Dict[str, tuple]) -> dict:
    """The numbers of ``prog`` against the reference: ``ref``, the
    reference's readings from the run's start, and ``want``, by group, the
    reference's first gradients and its last step (``Forced``) from
    ``prog``'s state."""
    out = {"batch_gap": batch_gap(prog.batches, ref.batches)}
    for g, names in group_names(list(ref.first), groups).items():
        sfx = f"_{g}" if g else ""
        first, forced = want[g]
        out["grad_err" + sfx] = pooled(prog.first, first, first, names)
        counts = all(prog.after.get(k, (None,) * 3)[2] == forced.t[k]
                     for k in names)
        prog_m = {k: prog.after[k][1] for k in names if k in prog.after}
        out["replay_err" + sfx] = pooled(prog_m, forced.m, forced.wrote,
                                         names) if counts else math.inf
    floor = threshold(ref.moments)
    gap, at = leaf_gap(masked_norms(prog.change, ref.moments, floor),
                       masked_norms(ref.change, ref.moments, floor))
    out.update({"change_gap": gap, "change_leaf": at,
                "loss_gap": loss_gap(prog.losses, ref.losses),
                "loss_gap_step1": loss_gap(prog.losses[:1], ref.losses[:1])})
    return out


def relative(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in f64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))
