"""Reference checkpoint import (``vgd_tpu/io/torch_import.py``): the
reference's PyTorch ``state_dict`` files (``vaegan_code.py:193``,
``main_vae.py:204-205``, ``gan_code.py:235``, the DDPM UNet of
``diffusion_model.py`` and the Glow of ``nf_code.py``) mapped onto the
NHWC parameter trees of the JAX package, then into the port's modules
through the weight bridge (``io/jax_params.py``, ``load_into``).

The mappers are the port's own numpy copy of the JAX package's:

* Conv2d weight   (O, I, kh, kw) -> (kh, kw, I, O)   [HWIO]
* ConvTranspose2d (I, O, kh, kw) -> (kh, kw, I, O)   (unflipped)
* Linear weight   (O, I)         -> (I, O)
* BatchNorm weight / bias / running_mean / running_var -> scale / bias /
  mean / var

A ``state_dict`` whose keys all start with ``module.`` (``nn.DataParallel``,
as the reference saves Glow) is read without the prefix. So a DDPM
``.pth`` of the reference loads into ``UNet`` (``load_into(model,
import_unet(path))``) and is served on the card through K3 and K4.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from vgd_tpu_torch.io.jax_params import from_jax_glow_params, load_jax_params


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The ``state_dict`` at ``path`` as numpy arrays (CPU), the
    ``module.`` prefix stripped when every key has it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
           for k, v in sd.items()}
    if out and all(k.startswith("module.") for k in out):
        out = {k[len("module."):]: v for k, v in out.items()}
    return out


def conv_w(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def convT_w(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kh, kw) -> HWIO (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 0, 1))


def linear_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _bn(sd, prefix):
    return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]})


def import_generator(path: str, n_up: int, nc: int = 3) -> Dict:
    """Reference Generator (``gan_code.py:16-54``; ``main.{3i}`` the convT,
    ``main.{3i+1}`` its BN for i in 0..n_up, ``main.{3(n_up+1)}`` the last
    3x3 layer) -> {"params", "batch_stats"}. The last layer is a stride-1
    ConvTranspose2d in the reference (weight (I, O, kh, kw)) and a plain
    conv here: its kernel is flipped and its I / O swapped when the weight
    has the convT layout (told by the ``nc`` output axis)."""
    sd = load_state_dict(path)
    params, stats = {}, {}
    for i in range(n_up + 1):
        params[f"up{i}"] = {"kernel": convT_w(sd[f"main.{3 * i}.weight"])}
        params[f"bn{i}"], stats[f"bn{i}"] = _bn(sd, f"main.{3 * i + 1}")
    w = sd[f"main.{3 * (n_up + 1)}.weight"]
    if w.shape[1] == nc and w.shape[0] != nc:
        w = np.transpose(w, (1, 0, 2, 3))[:, :, ::-1, ::-1]
    params["out"] = {"kernel": conv_w(np.ascontiguousarray(w))}
    return {"params": params, "batch_stats": stats}


def import_discriminator(path: str, n_down: int) -> Dict:
    """Reference Discriminator (``gan_code.py:56-89``; ``main.0`` the first
    conv, no BN; then the conv at ``main.{3i-1}`` and its BN at ``main.{3i}``
    for i in 1..n_down-1; the last conv after) -> {"params",
    "batch_stats"}."""
    sd = load_state_dict(path)
    params, stats = {"down0": {"kernel": conv_w(sd["main.0.weight"])}}, {}
    idx = 2
    for i in range(1, n_down):
        params[f"down{i}"] = {"kernel": conv_w(sd[f"main.{idx}.weight"])}
        params[f"bn{i}"], stats[f"bn{i}"] = _bn(sd, f"main.{idx + 1}")
        idx += 3
    params["out"] = {"kernel": conv_w(sd[f"main.{idx}.weight"])}
    return {"params": params, "batch_stats": stats}


def import_encoder(path: str) -> Dict:
    """Reference Encoder (``main_vae.py:34-58``) -> {"params",
    "batch_stats"}. torch flattens (C, H, W), the NHWC encoder (H, W, C):
    the fc weights' columns are permuted to match."""
    sd = load_state_dict(path)
    params, stats = {}, {}
    for i in range(4):
        params[f"conv{i}"] = {"kernel": conv_w(sd[f"cnn.{i}.conv.weight"]),
                              "bias": sd[f"cnn.{i}.conv.bias"]}
        params[f"bn{i}"], stats[f"bn{i}"] = _bn(sd, f"cnn.{i}.bn")
    c = sd["cnn.3.conv.weight"].shape[0]
    for name in ("fc_mu", "fc_logvar"):
        w = sd[f"{name}.weight"]                 # (latent, C*H*W)
        latent, flat = w.shape
        side = int(round((flat // c) ** 0.5))
        w = w.reshape(latent, c, side, side).transpose(0, 2, 3, 1)
        params[name] = {"kernel": w.reshape(latent, -1).T,
                        "bias": sd[f"{name}.bias"]}
    return {"params": params, "batch_stats": stats}


def import_unet(path: str, attention: bool = True) -> Dict:
    """Reference DDPM UNet (``diffusion_model.py:88-139`` /
    ``diffusion_model_no_attn.py:47-91``) -> {"params"}. Per ConvBlock:
    ``conv.0`` / ``conv.1`` (GroupNorm) / ``conv.3`` / ``conv.4``
    (GroupNorm), ``time_emb_proj``, ``residual_conv`` where in != out; the
    level-3 self-attention the reference never calls is skipped."""
    sd = load_state_dict(path)

    def dense(name):
        return {"kernel": linear_w(sd[f"{name}.weight"]),
                "bias": sd[f"{name}.bias"]}

    def conv(name):
        return {"kernel": conv_w(sd[f"{name}.weight"]),
                "bias": sd[f"{name}.bias"]}

    def norm(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    params: Dict = {"time_mlp1": dense("time_mlp.0"),
                    "time_mlp2": dense("time_mlp.2")}
    for blk in ("down1", "down2", "down3", "bottleneck", "up3", "up2", "up1"):
        params[blk] = {"conv1": conv(f"{blk}.conv.0"),
                       "gn1": norm(f"{blk}.conv.1"),
                       "conv2": conv(f"{blk}.conv.3"),
                       "gn2": norm(f"{blk}.conv.4"),
                       "time_proj": dense(f"{blk}.time_emb_proj")}
        if f"{blk}.residual_conv.weight" in sd:
            params[blk]["residual_conv"] = conv(f"{blk}.residual_conv")
    if attention:
        for name in ("cross_attn2", "cross_attn3"):
            params[name] = {"to_q": dense(f"{name}.to_q"),
                            "to_kv": dense(f"{name}.to_kv"),
                            "proj": dense(f"{name}.proj"),
                            "norm": norm(f"{name}.norm"),
                            "global_tokens": sd[f"{name}.global_tokens"]}
        params["attn_bottleneck"] = {
            "norm": norm("attn_bottleneck.norm"),
            "qkv": conv("attn_bottleneck.qkv"),
            "proj": conv("attn_bottleneck.proj")}
    params["out_conv"] = conv("out_conv")
    return {"params": params}


def import_glow(path: str, n_blocks: int, n_flows: int) -> Dict:
    """Reference Glow (``nf_code.py`` GlowModel / ``flow_eeg.py``) -> the
    params tree stacked over K: ``blocks.{i}.flows.{k}.ActNorm.{b,s}``,
    ``.InvConv.{P,L,U,S,S_sign}``, ``.AffCoupling.neuralnet.{0,2}`` and
    ``.4.conv`` + ``.4.scale``, and ``blocks.{i}.prior.conv`` +
    ``prior.scale``."""
    sd = load_state_dict(path)
    params: Dict = {}
    for i in range(n_blocks):
        leaves = {("actnorm", "b"): [], ("actnorm", "s"): [],
                  ("invconv", "P"): [], ("invconv", "L"): [],
                  ("invconv", "U"): [], ("invconv", "log_s"): [],
                  ("invconv", "s_sign"): [],
                  ("conv1", "w"): [], ("conv1", "b"): [],
                  ("conv2", "w"): [], ("conv2", "b"): [],
                  ("zero", "w"): [], ("zero", "b"): [], ("zero", "scale"): []}
        for k in range(n_flows):
            pre = f"blocks.{i}.flows.{k}"
            cp = f"{pre}.AffCoupling.neuralnet"
            for key, arr in (
                    (("actnorm", "b"), sd[f"{pre}.ActNorm.b"].reshape(-1)),
                    (("actnorm", "s"), sd[f"{pre}.ActNorm.s"].reshape(-1)),
                    (("invconv", "P"), sd[f"{pre}.InvConv.P"]),
                    (("invconv", "L"), sd[f"{pre}.InvConv.L"]),
                    (("invconv", "U"), sd[f"{pre}.InvConv.U"]),
                    (("invconv", "log_s"), sd[f"{pre}.InvConv.S"]),
                    (("invconv", "s_sign"), sd[f"{pre}.InvConv.S_sign"]),
                    (("conv1", "w"), conv_w(sd[f"{cp}.0.weight"])),
                    (("conv1", "b"), sd[f"{cp}.0.bias"]),
                    (("conv2", "w"), conv_w(sd[f"{cp}.2.weight"])),
                    (("conv2", "b"), sd[f"{cp}.2.bias"]),
                    (("zero", "w"), conv_w(sd[f"{cp}.4.conv.weight"])),
                    (("zero", "b"), sd[f"{cp}.4.conv.bias"]),
                    (("zero", "scale"), sd[f"{cp}.4.scale"].reshape(-1))):
                leaves[key].append(arr)
        flows: Dict = {"actnorm": {}, "invconv": {},
                       "coupling": {"conv1": {}, "conv2": {}, "zero": {}}}
        for (node, leaf), arrs in leaves.items():
            dst = flows[node] if node in flows else flows["coupling"][node]
            dst[leaf] = np.stack(arrs)
        prior = {"w": conv_w(sd[f"blocks.{i}.prior.conv.weight"]),
                 "b": sd[f"blocks.{i}.prior.conv.bias"],
                 "scale": sd[f"blocks.{i}.prior.scale"].reshape(-1)}
        params[f"block{i}"] = {"flows": flows, "prior": prior}
    return params


def load_into(model: nn.Module, variables: Dict) -> nn.Module:
    """Load an imported tree into the port's ``model`` strictly, through
    the weight bridge: a Glow tree (``block0`` at its top) with
    ``from_jax_glow_params``, else ``{"params"[, "batch_stats"]}`` with
    ``load_jax_params``."""
    if "block0" in variables:
        model.load_state_dict(from_jax_glow_params(variables, model),
                              strict=True)
        return model
    return load_jax_params(model, variables["params"],
                           variables.get("batch_stats"))
