"""Faults planted in the program under test, each a context manager over
a cell: the readings that set the limits of ``correct`` read them at the
cell's own size on the card, and the tests see each of them fail a run.

* ``half_batch``: every step trains on the first half of its batch, the
  mean taken over the rest;
* ``g_half_batch`` (VAE-GAN): only the encoder and decoder's step does;
* ``g_negated`` (VAE-GAN): the encoder and decoder's step descends the
  negated loss, so its gradient comes out negated where it is produced;
* ``stale_slot``: every replayed step (each after the step graph's eager
  warm-up) trains on the previous step's batch, as a graph whose input
  slot is not refreshed;
* ``repeated_draws``: every replayed step takes the draws of the last
  warm-up step again, as a graph that does not advance the generator.

A state left unchanged (an optimizer step that does nothing) reads
``change_gap`` 1 and needs no run.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = owner.__dict__[name]
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def half_batch(cell):
    return _patched(cell.module("families").TrainSystem, "step_fn",
                    lambda f: lambda self, b: f(self, b[:len(b) // 2]))


def g_half_batch(cell):
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer

    def make(f):
        def g_loss(self, x, eps, real_noisy, noise_fake, kl_ramp):
            h = x.shape[0] // 2
            return f(self, x[:h], eps[:h], real_noisy[:h], noise_fake[:h],
                     kl_ramp)
        return g_loss
    return _patched(VAEGANTrainer, "g_loss", make)


def g_negated(cell):
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer

    def make(f):
        def g_loss(self, *args):
            total, parts = f(self, *args)
            return -total, parts
        return g_loss
    return _patched(VAEGANTrainer, "g_loss", make)


def stale_slot(cell):
    from vgd_tpu_torch.train.common import WARMUP_STEPS, StepGraph

    def make(one):
        def stale(self, batch):
            prev, self._fault_prev = getattr(self, "_fault_prev", None), batch
            if self.steps_run >= WARMUP_STEPS and prev is not None:
                batch = prev
            return one(self, batch)
        return stale
    return _patched(StepGraph, "one", make)


def repeated_draws(cell):
    from vgd_tpu_torch.train.common import WARMUP_STEPS, StepGraph

    def make(one):
        def repeated(self, batch):
            g = self.generator
            if self.steps_run >= WARMUP_STEPS:
                g.set_state(self._fault_drawn)
            else:
                self._fault_drawn = g.get_state()
            return one(self, batch)
        return repeated
    return _patched(StepGraph, "one", make)


FAULTS = {"half_batch": half_batch, "g_half_batch": g_half_batch,
          "g_negated": g_negated, "stale_slot": stale_slot,
          "repeated_draws": repeated_draws}


def of(cell) -> list:
    """The faults that ``cell`` can have."""
    return [n for n in FAULTS
            if not n.startswith("g_") or cell.family == "vaegan"]
