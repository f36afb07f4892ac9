"""Checkpoints of the port: ``torch.save`` of params, step and config, and
for training the optimizer state and the random-generator state.

Counterpart of ``vgd_tpu/io/checkpoint.py`` (orbax there). One file per
step, ``<dir>/<step:08d>.pt``, holding ``{"params": state_dict on the CPU,
"step": int, "config": plain dict}`` and, when given, ``"opt_state"`` (an
optimizer ``state_dict``), ``"opt_step"`` (optimizer steps taken) and
``"rng_state"`` (``torch.Generator.get_state``, the counterpart of the JAX
checkpoint's ``rng_key``); the newest ``keep``
files are kept. A VAE-GAN checkpoint holds the three networks' parameters
and BatchNorm buffers in ``params`` under ``encoder.`` / ``decoder.`` /
``disc.`` and ``opt_state`` as ``{"encoder": ..., "decoder": ...,
"disc": ...}`` of the three Adam state_dicts. Files are read with ``weights_only=True``: tensors and
plain containers only.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_NAME = re.compile(r"^(\d{8})\.pt$")


class Checkpointer:
    """Save/restore ``(params, step, config)`` under ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step:08d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Dict[str, torch.Tensor],
             config: Optional[Dict[str, Any]] = None,
             opt_state: Optional[Dict[str, Any]] = None,
             rng_state: Optional[torch.Tensor] = None,
             opt_step: Optional[int] = None) -> str:
        payload = {"params": {k: v.detach().cpu() for k, v in params.items()},
                   "step": int(step), "config": config or {}}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if rng_state is not None:
            payload["rng_state"] = rng_state
        if opt_step is not None:
            payload["opt_step"] = int(opt_step)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))
        return path

    def load(self, step: Optional[int] = None, map_location="cpu"
             ) -> Dict[str, Any]:
        """The whole payload of ``step`` (default: the latest), params on
        ``map_location``. ``opt_state`` comes back on the CPU, as
        ``Optimizer.load_state_dict`` wants it (it moves the moments to
        their parameters and keeps Adam's step counts on the host), and so
        does ``rng_state``, as ``Generator.set_state`` wants it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        payload["params"] = {k: v.to(map_location)
                             for k, v in payload["params"].items()}
        return payload

    def restore(self, step: Optional[int] = None, map_location="cpu"
                ) -> Tuple[Dict[str, torch.Tensor], int, Dict[str, Any]]:
        """(params, step, config) of ``step`` (default: the latest)."""
        payload = self.load(step, map_location)
        return payload["params"], payload["step"], payload["config"]

