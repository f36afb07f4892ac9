"""Weight bridge: a JAX ``DiffusionState.params`` tree (as numpy arrays) to
the port's ``UNet`` state_dict, and its Adam state (``opt_state``) to a
``torch.optim.Adam`` state, so a JAX run can continue in the port.

Leaf conversions:

* conv ``kernel`` HWIO -> ``weight`` OIHW;
* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* ``bias`` as is;
* GroupNorm / LayerNorm ``scale`` -> ``weight``;
* ``global_tokens`` as is.

Module paths keep their names (``down1/conv1/kernel`` ->
``down1.conv1.weight``), so the channel order of the fused qkv and kv
projections (q | k | v, k | v) is carried over untouched. The bridge is
strict: a leaf it does not know raises, and with ``model`` given every JAX
leaf must land on a port parameter of the same shape and every port
parameter must be filled.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _convert(name: str, arr: np.ndarray, path: str):
    if name == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"{path}: kernel of rank {arr.ndim}")
    if name == "scale":
        return "weight", arr
    if name in ("bias", "global_tokens"):
        return name, arr
    raise ValueError(f"{path}: unknown parameter {name!r}")


def from_jax_params(params: Mapping, model: Optional[nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Convert a nested mapping of numpy arrays to a state_dict (f32 CPU
    tensors). With ``model``, check it is exactly that model's parameter
    set and shapes."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, path)
                continue
            name, arr = _convert(key, np.asarray(val), path)
            dotted = ".".join(path.split("/")[:-1] + [name])
            out[dotted] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    walk(params, "")
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in out.items()}
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        if missing or extra or wrong:
            raise ValueError(
                f"JAX params do not match the model: missing {missing}, "
                f"unused {extra}, shape mismatch "
                f"{[(k, got[k], want[k]) for k in wrong]}")
    return out


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Strictly load a JAX params tree into ``model`` (in place)."""
    model.load_state_dict(from_jax_params(params, model), strict=True)
    return model


def _adam_leaves(opt_state) -> Any:
    """The ``ScaleByAdamState`` of an ``optax.adam`` state: the state itself
    or the first entry of the chain's tuple, or a mapping with the same
    ``count`` / ``mu`` / ``nu`` fields."""
    node = opt_state
    if isinstance(node, (tuple, list)) and not hasattr(node, "mu"):
        node = node[0]
    if isinstance(node, Mapping):
        return node["count"], node["mu"], node["nu"]
    return node.count, node.mu, node.nu


def from_jax_adam_state(opt_state, model: nn.Module) -> Dict[str, Any]:
    """``optax.adam``'s (count, mu, nu) as the ``state`` of a
    ``torch.optim.Adam`` built over ``model.parameters()``: ``mu`` ->
    ``exp_avg``, ``nu`` -> ``exp_avg_sq`` (with the params' layout
    conversions), ``count`` -> ``step``. Strict like ``from_jax_params``:
    both moment trees must be exactly the model's parameter set."""
    count, mu, nu = _adam_leaves(opt_state)
    exp_avg = from_jax_params(mu, model)
    exp_avg_sq = from_jax_params(nu, model)
    step = float(np.asarray(count))
    return {i: {"step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": exp_avg[name], "exp_avg_sq": exp_avg_sq[name]}
            for i, (name, _) in enumerate(model.named_parameters())}


def load_jax_adam_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                        opt_state) -> torch.optim.Optimizer:
    """Load an ``optax.adam`` state into ``optimizer`` (an Adam over
    ``model.parameters()`` in that order), in place."""
    sd = optimizer.state_dict()
    n = sum(len(g["params"]) for g in sd["param_groups"])
    if n != len(list(model.parameters())):
        raise ValueError(f"optimizer holds {n} parameters, the model "
                         f"{len(list(model.parameters()))}")
    sd["state"] = from_jax_adam_state(opt_state, model)
    optimizer.load_state_dict(sd)
    return optimizer
