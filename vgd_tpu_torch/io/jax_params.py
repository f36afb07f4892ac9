"""Weight bridge: a JAX params tree (as numpy arrays) to the state_dict of
the port's counterpart module (the DDPM ``UNet``; the VAE-GAN, VAE and
DCGAN ``Encoder``, ``Generator`` and ``Discriminator``, with their
``batch_stats``; ``Glow``), and an optax Adam state (``opt_state``) to a
``torch.optim.Adam`` state, so a JAX run can continue in the port (the
trainers' states: ``load_jax_vaegan_state``, ``load_jax_vae_state``,
``load_jax_gan_state``, ``load_jax_glow_state`` for the image and the EEG
Glow trainers). ``from_jax_inception_params`` maps the Flax InceptionV3's
``params`` and ``batch_stats`` onto the port's ``eval.inception``
module.

Glow has its own converter (``from_jax_glow_params``): its tree is plain
(not Flax), its leaf names (``w``, ``P``, ``L``, ``U``, ``log_s``,
``s_sign``) are kept, and its ZeroConv ``scale`` is a scale, not a
normalisation weight.

Leaf conversions:

* conv ``kernel`` HWIO -> ``weight`` OIHW, transposed (3, 2, 0, 1);
* ``ConvTranspose`` ``kernel`` (HWIO, unflipped) -> ``weight`` (in, out,
  kh, kw), transposed (2, 3, 0, 1). Told apart by the port module the leaf
  lands on, not by shape (a shape check catches a wrong transpose only
  when in != out), so a tree with transposed convs needs ``model``;
* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* ``bias`` as is;
* GroupNorm / LayerNorm / BatchNorm ``scale`` -> ``weight``;
* ``global_tokens`` as is;
* ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

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

from vgd_tpu_torch.ops.conv import ConvTranspose
from vgd_tpu_torch.parallel.collectives import size
from vgd_tpu_torch.parallel.tensor_parallel import split_axis

_STATS = {"mean": "running_mean", "var": "running_var"}


def _convert(name: str, arr: np.ndarray, path: str, transposed: bool):
    if name == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose((2, 3, 0, 1) if transposed
                                           else (3, 2, 0, 1))
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"{path}: kernel of rank {arr.ndim}")
    if name == "scale":
        return "weight", arr
    if name in ("bias", "global_tokens"):
        return name, arr
    raise ValueError(f"{path}: unknown parameter {name!r}")


def _is_transposed(model: Optional[nn.Module], owner: str) -> bool:
    if model is None:
        return False
    try:
        return isinstance(model.get_submodule(owner), ConvTranspose)
    except AttributeError:
        return False            # no such module: the strict check reports it


def from_jax_params(params: Mapping, model: Optional[nn.Module] = None,
                    batch_stats: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """Convert a nested mapping of numpy arrays (and, when given, the
    ``batch_stats`` collection) to a state_dict of f32 CPU tensors. With
    ``model``, check it is exactly that model's parameter set and shapes,
    plus its buffers when ``batch_stats`` is given."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix, stats):
        for key, val in node.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, path, stats)
                continue
            owner = path.split("/")[:-1]
            if stats:
                if key not in _STATS:
                    raise ValueError(f"{path}: unknown batch stat {key!r}")
                name, arr = _STATS[key], np.asarray(val)
            else:
                name, arr = _convert(key, np.asarray(val), path,
                                     _is_transposed(model, ".".join(owner)))
            out[".".join(owner + [name])] = torch.from_numpy(
                np.array(arr, np.float32, order="C"))

    walk(params, "", False)
    if batch_stats is not None:
        walk(batch_stats, "", True)
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.named_parameters()}
        if batch_stats is not None:
            want.update((k, tuple(v.shape))
                        for k, v in model.named_buffers())
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


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Strictly load a JAX params tree (and ``batch_stats``, which a model
    with BatchNorm needs) into ``model`` (in place)."""
    model.load_state_dict(from_jax_params(params, model, batch_stats),
                          strict=True)
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


def load_jax_vaegan_state(trainer, state):
    """Load a JAX ``VAEGANState`` (its ``encoder`` / ``decoder`` / ``disc``
    each with ``params``, ``batch_stats`` and ``opt_state``, and ``step``;
    leaves as numpy or array-likes) into a ``train.vaegan.VAEGANTrainer``:
    weights, BN running stats and the three Adam states, strictly."""
    for name, net in trainer.nets().items():
        st = getattr(state, name)
        load_jax_params(net, st.params, st.batch_stats)
        load_jax_adam_state(trainer.opts[name], net, st.opt_state)
    trainer.step = int(np.asarray(state.step))
    return trainer


def load_jax_gan_state(trainer, state):
    """Load a JAX ``GANState`` (``gen`` / ``disc`` each with ``params``,
    ``batch_stats`` and ``opt_state``, and ``step``) into a
    ``train.gan.GANTrainer``: weights, BN running stats and both Adam
    states, strictly."""
    for name, net in trainer.nets().items():
        st = getattr(state, name)
        load_jax_params(net, st.params, st.batch_stats)
        load_jax_adam_state(trainer.opts[name], net, st.opt_state)
    trainer.step = int(np.asarray(state.step))
    return trainer


def load_jax_vae_state(trainer, state):
    """Load a JAX ``VAEState`` into a ``train.vae.VAETrainer``: both
    networks' weights and BN running stats, and the joint optax Adam state
    (held by ``state.decoder.opt_state``, its moments a ``{"enc", "dec"}``
    tree) as the joint Adam over the encoder's parameters, then the
    decoder's; strictly."""
    nets = {"enc": trainer.encoder, "dec": trainer.decoder}
    for tree, net in zip((state.encoder, state.decoder), nets.values()):
        load_jax_params(net, tree.params, tree.batch_stats)
    count, mu, nu = _adam_leaves(state.decoder.opt_state)
    for what, tree in (("mu", mu), ("nu", nu)):
        if set(tree) != set(nets):
            raise ValueError(f"JAX Adam {what} holds {sorted(tree)}, want "
                             f"{sorted(nets)}")
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    moments = []
    for k, net in nets.items():
        m, v = from_jax_params(mu[k], net), from_jax_params(nu[k], net)
        moments += [(m[name], v[name]) for name, _ in net.named_parameters()]
    sd = trainer.opt.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
                   for i, (m, v) in enumerate(moments)}
    trainer.opt.load_state_dict(sd)
    trainer.step = int(np.asarray(state.step))
    return trainer


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _strict(got: Dict[str, np.ndarray], want: Dict[str, tuple], what: str):
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    wrong = sorted(k for k in set(want) & set(got)
                   if tuple(got[k].shape) != want[k])
    if missing or extra or wrong:
        raise ValueError(
            f"{what} do not match the model: missing {missing}, unused "
            f"{extra}, shape mismatch "
            f"{[(k, tuple(got[k].shape), want[k]) for k in wrong]}")


def _glow_shapes(model: nn.Module) -> Dict[str, tuple]:
    """The full (unsharded) shape of every state-dict entry of a port
    ``Glow``: a tensor-parallel model's split leaves times its model
    group's size along their split axis."""
    p = size(getattr(model, "tp_group", None))
    shapes = {}
    for k, v in model.state_dict().items():
        shape, axis = list(v.shape), split_axis(k)
        if axis is not None:
            shape[axis] *= p
        shapes[k] = tuple(shape)
    return shapes


def from_jax_glow_params(params: Mapping, model: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """A JAX Glow params tree (``block{i}/flows/...`` stacked over K,
    ``block{i}/prior``) as the full state_dict of the port's ``Glow``:
    every leaf keeps its name and layout (HWIO kernels, ZeroConv ``scale``
    stays ``scale``); the PLU buffers ``P`` and ``s_sign`` included.
    Strict: every leaf lands on a tensor of the same (full) shape and every
    tensor is filled."""
    got = _flatten(params)
    _strict(got, _glow_shapes(model), "JAX Glow params")
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in got.items()}


def load_jax_glow_state(trainer, state):
    """Load a JAX ``GlowState`` (``params``, the optax Adam ``opt_state``,
    ``step``; leaves as numpy or array-likes) into a
    ``train.glow.GlowTrainer`` or ``GlowEEGTrainer``: parameters, the P /
    s_sign buffers, Adam's moments and count, the iteration, through
    ``trainer.load`` (which cuts a tensor-parallel trainer's shard from
    the full state). The optax state also holds moments for P and s_sign,
    which never get a gradient: they must be zero and are dropped (the
    port's Adam holds the trainable leaves only)."""
    model = trainer.model
    params = from_jax_glow_params(state.params, model)
    count, mu, nu = _adam_leaves(state.opt_state)
    names = [k for k, _ in model.named_parameters()]
    buffers = {k for k, _ in model.named_buffers()}
    moments = []
    for tree in (mu, nu):
        flat = _flatten(tree)
        _strict(flat, _glow_shapes(model), "JAX Adam moments")
        for k in buffers:
            if np.any(flat[k] != 0):
                raise ValueError(f"JAX Adam moment of the buffer {k} is not "
                                 f"zero")
        moments.append({k: torch.from_numpy(np.array(flat[k], np.float32))
                        for k in names})
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    trainer._fresh_optimizer()
    sd = trainer.opt.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": moments[0][k],
                       "exp_avg_sq": moments[1][k]}
                   for i, k in enumerate(names)}
    trainer.load(params, sd, int(np.asarray(state.step)))
    return trainer


def from_jax_inception_params(params: Mapping, batch_stats: Mapping,
                              model: nn.Module) -> Dict[str, torch.Tensor]:
    """The Flax InceptionV3's ``params`` and ``batch_stats`` (module paths
    ``Conv2d_1a_3x3/conv/kernel``, ``Mixed_5b/branch1x1/bn/scale``,
    ``fc/kernel``, ...) as the state_dict of the port's
    ``eval.inception.InceptionV3``: the leaf conversions of
    ``from_jax_params``, each BatchNorm's ``num_batches_tracked`` 0.
    Strict, as ``from_jax_params`` with a model."""
    sd = from_jax_params(params, None, batch_stats)
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros_like(buf, device="cpu")
    _strict(sd, {k: tuple(v.shape) for k, v in model.state_dict().items()},
            "JAX Inception variables")
    return sd
