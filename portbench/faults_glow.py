"""Faults planted in the Glow program under test, each a context manager
over a cell (``faults.py``'s form): ``readings_glow.py`` reads them at the
cell's own size on the card, and the tests see each of them fail a run.

* ``logdet_dropped``: block 0's log-determinant (its ActNorms' and 1x1
  convolutions') left out of the loss;
* ``half_batch``: every train step trains on the first half of its batch,
  the mean taken over the rest (the init sees the whole batch);
* ``repeated_draws``: every step after the first takes the first step's
  dequantisation draws again, as a trainer that does not advance the
  generator;
* ``stale_slot``: each staging buffer is filled once only, so from the
  ring's second turn on a step trains on the rows an earlier step had.

A state left unchanged (an optimizer step that does nothing) reads
``change_gap`` 1 and needs no run.
"""
from __future__ import annotations

from portbench.faults import _patched


def logdet_dropped(cell):
    from vgd_tpu_torch.models.glow import Glow

    def make(f):
        def block_fwd(self, blk, x, split, init):
            y, ld, lp, z, stats = f(self, blk, x, split, init)
            if blk is self.block0 and not init:
                ld = ld * 0.0
            return y, ld, lp, z, stats
        return block_fwd
    return _patched(Glow, "_block_fwd", make)


def half_batch(cell):
    from vgd_tpu_torch.train.glow import _GlowTrainerBase

    def make(f):
        def train_step(self, batch, generator=None, noise=None):
            return f(self, batch[:len(batch) // 2], generator, noise)
        return train_step
    return _patched(_GlowTrainerBase, "train_step", make)


def repeated_draws(cell):
    from vgd_tpu_torch.train.glow import _GlowTrainerBase

    def make(f):
        def noise(self, x, generator, given):
            if self.step == 0:
                self._fault_drawn = generator.get_state()
            else:
                generator.set_state(self._fault_drawn)
            return f(self, x, generator, given)
        return noise
    return _patched(_GlowTrainerBase, "_noise", make)


def stale_slot(cell):
    from vgd_tpu_torch.train.loop import _Staging

    def make(f):
        def fill(self, data, sels, buf):
            filled = self.__dict__.setdefault("_fault_filled", set())
            if buf.data_ptr() not in filled:
                filled.add(buf.data_ptr())
                f(self, data, sels, buf)
        return fill
    return _patched(_Staging, "fill", make)


FAULTS = {"logdet_dropped": logdet_dropped, "half_batch": half_batch,
          "repeated_draws": repeated_draws, "stale_slot": stale_slot}
