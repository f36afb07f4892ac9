"""Serving export (``vgd_tpu/io/export.py``): a trained checkpoint's
inference program traced once with ``torch.export`` and written as one
file that a serving process runs without the model code, the config or the
checkpoint.

The artifact ``<path>`` (default ``<out-dir>/serving_<family>_<mode>.pt2``)
is ``torch.export.save`` of an ``ExportedProgram`` with the trained
parameters in it; ``<path>.json`` is a readable sidecar (family, mode, n,
step, ``ddim_steps``, ``ddim_eta``, ``poly_batch``, config, input and
output specs, platforms, nbytes) that loaders can index without reading the
program. The kernels on the serving paths are registered ops
(``vgd::flash_attention``, ``vgd::groupnorm_silu``,
``vgd::glow_coupling_fwd``), so the program records the op nodes and not
their plain arithmetic; loading needs only ``vgd_tpu_torch.ops.kernels``,
which registers them.

Where the JAX export differs:

* The random draws are inputs of the program. ``run_artifact(seed)`` draws
  them from ``torch.Generator("cpu").manual_seed(seed)`` in the order of
  the program's inputs (``z``; ``eps``; ``xt``, then each step's
  ``noise``), so one seed gives one sample stream on the card and on the
  CPU, the property the JAX package gets from threefry; ``draws=`` feeds
  given ones (the tests feed JAX's).
* ``diffusion`` exports one denoising step (the fused UNet and the
  ancestral or DDIM update, its timesteps as tensor inputs):
  ``torch.export`` unrolls Python loops and has no stable loop counterpart
  of ``lax.fori_loop``, and a 1000-step chain cannot be unrolled.
  ``run_artifact`` runs the steps the artifact holds (``steps``: t, or t
  and the next entry, T after the last), then clips to [-1, 1]. The
  ancestral chain runs t = T-1 .. 0, as the port's eager sampler.
* One file serves every listed platform: the program is traced on the
  CPU, and ``load_artifact(path, device)`` moves it
  (``torch.export.passes.move_to_device_pass``). ``tpu`` is refused.
* ``glow`` / ``glow-eeg`` take their per-block z as one input ``z`` (n,
  sum of the block sizes), each block's part in order, cut and reshaped
  inside the program.

``family``, the program's own format version and the diffusion steps ride
inside the ``.pt2`` as well (``extra_files``); mode, n and ``poly_batch``
are read from the program's inputs, so an artifact runs without its
sidecar. A newer ``format_version`` (in either) is refused.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# registers the vgd:: ops, which loading an artifact needs
from vgd_tpu_torch.ops import kernels  # noqa: F401

FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
_META = "vgd_meta.json"             # the program's own meta, in the .pt2
FAMILIES = ("vaegan", "vae", "gan", "wgan", "glow", "glow-eeg", "diffusion")


class _Decode(nn.Module):
    """z -> images: the VAE / VAE-GAN decoder or the GAN generator, eval
    mode."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, z):
        if z.ndim == 2:
            z = z[:, None, None, :]
        return self.net(z, train=False).float()


class _Denoise(nn.Module):
    """(x, eps) -> reconstruction: encode, reparameterize with ``eps``,
    decode, eval mode."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def forward(self, x, eps):
        from vgd_tpu_torch.models.vae import reparameterize
        mu, logvar = self.encoder(x, train=False)
        z, _ = reparameterize(mu, logvar, eps)
        return self.decoder(z[:, None, None, :], train=False).float()


class _GlowSample(nn.Module):
    """z (n, sum of the block sizes) -> the reverse flow of z times the
    temperature, times ``scale``."""

    def __init__(self, model: nn.Module, z_shapes, temperature: float,
                 scale: float):
        super().__init__()
        self.model = model
        self.z_shapes = [tuple(s) for s in z_shapes]
        self.temperature, self.scale = temperature, scale

    def forward(self, z):
        n = z.shape[0]
        sizes = [int(np.prod(s)) for s in self.z_shapes]
        zs = [part.reshape((n,) + s) * self.temperature
              for part, s in zip(z.split(sizes, dim=1), self.z_shapes)]
        x = self.model.reverse(zs)
        return (x * self.scale if self.scale != 1.0 else x).float()


class _AncestralStep(nn.Module):
    """(x, t, noise) -> x at t - 1 (``DiffusionTrainer.ancestral_step``)."""

    def __init__(self, trainer):
        super().__init__()
        self.unet = trainer.model_fused
        self.trainer = trainer

    def forward(self, x, t, noise):
        return self.trainer.ancestral_step(x, t, noise)


class _DDIMStep(nn.Module):
    """(x, t, t_prev[, noise]) -> x at t_prev (``DiffusionTrainer.
    ddim_step``); ``noise`` only where eta > 0."""

    def __init__(self, trainer, eta: float):
        super().__init__()
        self.unet = trainer.model_fused
        self.trainer = trainer
        self.register_buffer("eta", torch.tensor(eta, dtype=torch.float32))

    def forward(self, x, t, t_prev, noise=None):
        return self.trainer.ddim_step(x, t, t_prev, self.eta, noise)


def _steps(cfg, ddim_steps: int) -> List[List[int]]:
    """The step inputs ``run_artifact`` feeds in order: [t] for t = T-1 ..
    0 (ancestral), or [tau, next tau] over the DDIM subsequence, T after
    the last."""
    from vgd_tpu_torch.train.diffusion import ddim_timesteps
    T = cfg.timesteps
    if ddim_steps <= 0:
        return [[t] for t in range(T - 1, -1, -1)]
    taus = [int(t) for t in ddim_timesteps(T, ddim_steps)[::-1]]
    return [[a, b] for a, b in zip(taus, taus[1:] + [T])]


def build_serving_fn(family: str, cfg, trainer, n: int,
                     mode: str = "sample", ddim_steps: int = 0,
                     ddim_eta: float = 0.0, poly_batch: bool = False
                     ) -> Tuple[nn.Module, Tuple[torch.Tensor, ...]]:
    """``(fn, example_args)``: the family's inference program as a module
    over ``trainer``'s networks (their parameters become the program's),
    and example inputs on the trainer's device.

    mode="sample":  fn(z) -> images f32 (n, H, W, C) in [-1, 1]
                    (glow-eeg: signals (n, T, 1, C)); z is (n, latent)
                    for vae / vaegan, (n, 1, 1, latent) for gan / wgan, (n,
                    sum of the block sizes) for glow / glow-eeg;
                    diffusion: one step, fn(x, t, noise) (ancestral) or
                    fn(x, t, t_prev[, noise]) (DDIM; noise where eta > 0)
    mode="denoise": fn(x (b, H, W, C) in [-1, 1], eps (b, latent)) ->
                    reconstruction f32 (vae / vaegan)

    ``poly_batch`` (denoise only): the batch dimension is symbolic, so one
    artifact serves any request batch size; a sample program's batch is
    fixed at export (its draws set it)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    dev = getattr(trainer, "device", torch.device("cpu"))
    if mode == "denoise":
        if family not in ("vae", "vaegan"):
            raise ValueError(f"denoise export supports vae/vaegan, "
                             f"not {family!r}")
        x = torch.zeros((n,) + tuple(trainer.img_shape), device=dev)
        eps = torch.zeros((n, cfg.latent_dim), device=dev)
        return _Denoise(trainer.encoder, trainer.decoder).eval(), (x, eps)
    if poly_batch:
        raise ValueError("poly_batch applies to denoise exports only: a "
                         "sample-mode program takes its draws for a batch "
                         "fixed at export")
    if mode != "sample":
        raise ValueError(f"unknown export mode {mode!r}")
    if family in ("vae", "vaegan"):
        fn = _Decode(trainer.decoder)
        args = (torch.zeros((n, cfg.latent_dim), device=dev),)
    elif family in ("gan", "wgan"):
        fn = _Decode(trainer.gen)
        args = (torch.zeros((n, 1, 1, cfg.latent_dim), device=dev),)
    elif family in ("glow", "glow-eeg"):
        fn = _GlowSample(trainer.model, trainer.z_shapes, cfg.temperature,
                         2.0 if family == "glow" else 1.0)
        size = sum(int(np.prod(s)) for s in trainer.z_shapes)
        args = (torch.zeros((n, size), device=dev),)
    else:
        x = torch.zeros((n,) + tuple(trainer.img_shape), device=dev)
        t = torch.tensor(cfg.timesteps - 1, device=dev)
        if ddim_steps > 0:
            fn = _DDIMStep(trainer, ddim_eta)
            args = (x, t, torch.tensor(cfg.timesteps, device=dev)) + \
                ((torch.zeros_like(x),) if ddim_eta != 0.0 else ())
        else:
            fn = _AncestralStep(trainer)
            args = (x, t, torch.zeros_like(x))
    return fn.eval(), args


def _spec(node) -> str:
    v = node.meta.get("val")
    if v is None or not hasattr(v, "shape"):
        return f"{node.name}: {v!r}"
    dims = ",".join(str(d) if isinstance(d, int) else "b" for d in v.shape)
    return f"{node.name}: {str(v.dtype).replace('torch.', '')}[{dims}]"


def _user_inputs(ep) -> list:
    names = set(ep.graph_signature.user_inputs)
    return [nd for nd in ep.graph.nodes
            if nd.op == "placeholder" and nd.name in names]


def _outputs(ep) -> list:
    out = next(nd for nd in ep.graph.nodes if nd.op == "output")
    return [a for a in out.args[0] if hasattr(a, "meta")]


def export_artifact(fn: nn.Module, example_args, path: str,
                    platforms: Sequence[str] = PLATFORMS,
                    meta: Optional[dict] = None,
                    poly_batch: bool = False) -> dict:
    """Trace ``fn`` on ``example_args`` (the first input's batch symbolic
    with ``poly_batch``), save the program with its meta inside, write the
    sidecar. Returns the sidecar dict."""
    platforms = [p.strip() for p in platforms]
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad}: the port's artifacts run on "
                         f"{list(PLATFORMS)} (a TPU program is the JAX "
                         f"package's .jaxexport)")
    dynamic = None
    if poly_batch:
        b = torch.export.Dim("b", min=1, max=65535)
        dynamic = tuple({0: b} for _ in example_args)
    with torch.no_grad():
        ep = torch.export.export(fn, tuple(example_args),
                                 dynamic_shapes=dynamic)
    meta = dict(meta or {})
    inner = {k: meta[k] for k in ("family", "steps") if k in meta}
    inner["format_version"] = FORMAT_VERSION
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path, extra_files={_META: json.dumps(inner)})
    meta.update(format_version=FORMAT_VERSION, platforms=platforms,
                in_specs=[_spec(nd) for nd in _user_inputs(ep)],
                out_specs=[_spec(nd) for nd in _outputs(ep)],
                nbytes=os.path.getsize(path))
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return meta


def _check_version(fv, where: str) -> None:
    if fv is not None and int(fv) > FORMAT_VERSION:
        raise ValueError(
            f"{where}: artifact format_version {fv} is newer than this "
            f"loader's {FORMAT_VERSION}: upgrade vgd_tpu_torch to run it")


def load_artifact(path: str, device="cuda"):
    """Read an artifact and move it to ``device`` (``cuda`` unless the
    caller asks for the CPU); returns ``(call, meta)``. ``call`` takes the
    program's inputs (``meta['in_specs']``) on ``meta['device']``.

    The sidecar is optional: family and the diffusion steps ride inside
    the ``.pt2``, and mode, n and ``poly_batch`` are read from the
    program's own inputs (a denoise program takes (x, eps), a diffusion
    step (x, t, ...), a sampler its draws), so a sidecar-less artifact
    still runs. A device the sidecar's ``platforms`` does not list is
    refused, and so is ``tpu``."""
    from torch.export.passes import move_to_device_pass

    from vgd_tpu_torch.core.rng import resolve_device

    if str(device).startswith("tpu"):
        raise ValueError("tpu: the port's artifacts run on cuda or cpu; a "
                         "TPU serves the JAX package's .jaxexport")
    extra = {_META: ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META]) if extra[_META] else {}
    _check_version(meta.get("format_version"), path)
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            side = json.load(f)
        _check_version(side.get("format_version"), path + ".json")
        meta.update(side)
    dev = torch.device(device)
    if dev.type not in meta.get("platforms", PLATFORMS):
        raise ValueError(f"{path} was exported for {meta['platforms']}, "
                         f"not {dev.type}")
    dev = resolve_device(dev)
    inputs = _user_inputs(ep)
    names = [nd.name for nd in inputs]
    shape0 = inputs[0].meta["val"].shape
    meta.setdefault("mode", "denoise" if names[:2] == ["x", "eps"]
                    else "sample")
    if isinstance(shape0[0], int):
        meta.setdefault("n", shape0[0])
    else:                              # symbolic batch (poly_batch export)
        meta.setdefault("poly_batch", True)
    meta.setdefault("in_specs", [_spec(nd) for nd in inputs])
    meta["inputs"] = [(nd.name, [d if isinstance(d, int) else None
                                 for d in nd.meta["val"].shape])
                      for nd in inputs]
    meta["device"] = str(dev)
    ep = move_to_device_pass(ep, dev)
    return ep.module(), meta


def export_serving(family: str, cfg, n: int = 64, mode: str = "sample",
                   step: Optional[int] = None, ddim_steps: int = 0,
                   ddim_eta: float = 0.0,
                   platforms: Sequence[str] = PLATFORMS,
                   artifact_path: Optional[str] = None,
                   poly_batch: bool = False) -> str:
    """Restore ``family``'s latest (or ``step``) checkpoint under
    ``cfg.run.out_dir`` on the CPU (the program is traced there and moved
    at load) and export its serving program. Returns the artifact path."""
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L

    restore = {"vaegan": L.restore_vaegan, "vae": L.restore_vae,
               "gan": L.restore_gan, "wgan": L.restore_gan,
               "glow": L.restore_glow, "glow-eeg": L.restore_glow_eeg,
               "diffusion": L.restore_trainer}
    if family not in restore:
        raise ValueError(f"unknown family {family!r}")
    od = cfg.run.out_dir
    ckpt_dir = os.path.join(od, f"ckpt_{cfg.event_type}"
                            if family == "glow-eeg" else "ckpt")
    trainer = restore[family](cfg, step, device="cpu")
    step = Checkpointer(ckpt_dir).latest_step() if step is None else step
    fn, example_args = build_serving_fn(
        family, cfg, trainer, n, mode=mode, ddim_steps=ddim_steps,
        ddim_eta=ddim_eta, poly_batch=poly_batch)
    artifact_path = artifact_path or os.path.join(
        od, f"serving_{family}_{mode}.pt2")
    meta = dict(family=family, mode=mode, n=n, step=int(step),
                ddim_steps=ddim_steps, ddim_eta=ddim_eta,
                poly_batch=poly_batch, config=dataclasses.asdict(cfg))
    if family == "diffusion":
        meta["steps"] = _steps(cfg, ddim_steps)
    export_artifact(fn, example_args, artifact_path, platforms=platforms,
                    meta=meta, poly_batch=poly_batch)
    print(f"[export] {family}/{mode} step {step} -> {artifact_path} "
          f"({os.path.getsize(artifact_path)} bytes, platforms "
          f"{list(platforms)})")
    return artifact_path


def serving_draws(meta: dict, seed: int, batch: Optional[int] = None
                  ) -> Dict[str, object]:
    """The draws ``run_artifact`` feeds for ``seed``, from one CPU
    generator in input order: each sampler input, or ``eps`` (denoise, for
    ``batch`` rows), or ``xt`` and then each step's ``noise`` (diffusion).
    Float32 CPU tensors; ``noise`` a list, one per step."""
    gen = torch.Generator("cpu").manual_seed(int(seed))
    specs = dict(meta["inputs"])

    def draw(name):
        shape = [batch if d is None else d for d in specs[name]]
        return torch.randn(shape, generator=gen)

    if "t" in specs:
        out = {"xt": draw("x")}
        if "noise" in specs:
            out["noise"] = [draw("noise") for _ in meta["steps"]]
        return out
    names = [nm for nm, _ in meta["inputs"]]
    return {nm: draw(nm) for nm in (names[1:] if meta["mode"] == "denoise"
                                    else names)}


def run_artifact(artifact_path: Optional[str] = None, seed: int = 0,
                 inputs: Optional[np.ndarray] = None, loaded=None,
                 draws: Optional[Dict[str, object]] = None,
                 device="cuda") -> np.ndarray:
    """One serving call, the serving hot path. ``inputs`` (float (b, H, W,
    C) in [-1, 1]) is required for denoise artifacts. ``loaded``: a
    ``(call, meta)`` pair from ``load_artifact``, so a caller that read the
    meta does not read the file twice (``device`` is then the one it was
    loaded for). ``draws``: the random inputs by name (``serving_draws``'s
    keys, arrays or tensors), instead of drawing them from ``seed``."""
    call, meta = loaded if loaded is not None else load_artifact(
        artifact_path, device)
    dev = torch.device(meta["device"])

    def on_dev(a):
        a = a if torch.is_tensor(a) else torch.from_numpy(
            np.array(a, np.float32))
        return a.to(dev, torch.float32)

    with torch.no_grad():
        if meta.get("mode") == "denoise":
            if inputs is None:
                raise ValueError("denoise artifact needs `inputs`")
            x = on_dev(inputs)
            d = draws or serving_draws(meta, seed, batch=x.shape[0])
            out = call(x, on_dev(d["eps"]))
        elif "t" in dict(meta["inputs"]):
            d = draws or serving_draws(meta, seed)
            x = on_dev(d["xt"])
            noise = d.get("noise")
            for i, ts in enumerate(meta["steps"]):
                args = [torch.tensor(t, device=dev) for t in ts]
                if noise is not None:
                    args.append(on_dev(noise[i]))
                x = call(x, *args)
            out = torch.clamp(x, -1.0, 1.0)
        else:
            d = draws or serving_draws(meta, seed)
            out = call(*(on_dev(d[nm]) for nm, _ in meta["inputs"]))
    return out.cpu().numpy()
