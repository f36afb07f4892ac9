"""DDPM schedule, forward process, trainer and samplers
(``vgd_tpu/train/diffusion.py``).

``DiffusionTrainer`` holds two UNets over ONE set of parameters, as the JAX
trainer holds two modules over one param tree: ``model``, the training
form (attention through the differentiable K2 kernels, stock GroupNorm), and
``model_fused`` (K3 and K4), which the samplers run. An optimizer step on
``model`` is what the samplers see next; nothing is copied.

The train step draws its timesteps and noise from an explicit
``torch.Generator`` or takes them as arguments, so a test can hand both
packages the same draws. Losses stay on the device; the caller decides
when to read them. ``train_step`` can be captured as a CUDA graph, its t
and noise draws inside (the epoch scan, ``common.StepGraph``); its Adam is
``capturable`` on a card.

Under data parallelism (``mesh``) the trainer holds this rank's rows of
the global batch: t and the noise are drawn for the global batch and
sliced (given draws are the global batch's too), the gradients are
averaged over the data axis before the Adam step, and the loss comes back
as the global batch's. A model axis > 1 routes the bottleneck
self-attention of both UNets through ring attention over the model group
(sequence parallelism, ``parallel/sequence_parallel.py``), as JAX's
``sp_mesh`` does; the ranks of one model group hold the same rows, and the
gradients are averaged over the whole world (``Mesh.grad_group``), so that
the replicas stay bit-equal on a card whose backward adds with atomics.

The samplers run eagerly under ``torch.inference_mode()``, one UNet
forward per step. Scalar schedule entries stay 0-d f32 tensors on the
device, so the update arithmetic is f32 as in the JAX package and no step
waits on the host. Each sampler draws its Gaussian noise from an explicit
``torch.Generator``, or takes a ``noise`` sequence of one tensor per
executed step, so a test can hand both packages the same draws. A
sampler's chain, each of its steps and each UNet forward are the spans
``vgd.sample.request``, ``vgd.sample.step`` and ``vgd.sample.forward``
(``utils.trace``: recorded only while a profiler is active); the least
host seconds of a forward are always kept in ``trace.COUNTERS``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vgd_tpu_torch.core.config import DiffusionConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.models.unet import UNet
from vgd_tpu_torch.ops.image import to_signed
from vgd_tpu_torch.parallel.collectives import average_grads
from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
from vgd_tpu_torch.train.common import (DTYPES, adam, batch_draw,
                                         mean_metrics, mse)
from vgd_tpu_torch.utils import trace


class Schedule(NamedTuple):
    """Precomputed DDPM schedule tensors (f32, on the device)."""
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor


def make_schedule(timesteps: int, start: float = 1e-4, end: float = 0.02,
                  device="cpu") -> Schedule:
    """Linear beta schedule and its derived quantities, in f32, computed on
    the CPU and then moved to ``device``: a cumulative product on the card
    rounds in another order, and the table must be the same bits on every
    device (an exported program bakes in the table its CPU trace made)."""
    betas = torch.linspace(start, end, timesteps, dtype=torch.float32)
    alphas = 1.0 - betas
    acp = torch.cumprod(alphas, dim=0)
    acp_prev = torch.cat([torch.ones(1, dtype=torch.float32), acp[:-1]])
    return Schedule(*(t.to(device) for t in (
        betas, alphas, acp, acp_prev, torch.sqrt(acp), torch.sqrt(1.0 - acp),
        betas * (1.0 - acp_prev) / (1.0 - acp))))


def q_sample(sched: Schedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion sqrt(abar_t) x0 + sqrt(1 - abar_t) noise."""
    t = t.long()
    a = sched.sqrt_alphas_cumprod[t][:, None, None, None]
    b = sched.sqrt_one_minus_alphas_cumprod[t][:, None, None, None]
    return a * x0 + b * noise


def ddim_timesteps(timesteps: int, num_steps: int) -> np.ndarray:
    """Ascending DDIM subsequence of {0..T-1}: evenly spaced, rounded, with
    the duplicates that rounding produces removed (each would cost a UNet
    forward and change nothing)."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if num_steps >= 2:
        return np.unique(np.round(
            np.linspace(0.0, timesteps - 1, num_steps)).astype(np.int32))
    return np.array([timesteps - 1], np.int32)


def sample_timestep_uniform(generator: Optional[torch.Generator],
                            batch_size: int, t_max: int,
                            device="cpu") -> torch.Tensor:
    """t ~ U{0..t_max-1}, int64 (the JAX package draws int32; an index
    either way)."""
    return torch.randint(0, t_max, (batch_size,), generator=generator,
                         device=device)


def sample_timestep_sinusoidal(batch_size: int, t_max: int, epoch: float,
                               total_epochs: float) -> torch.Tensor:
    """Phase-shifting sine schedule over the batch, int32 (unused by the
    training loop, kept for parity)."""
    phase = (epoch / total_epochs) * 3.1416
    grid = torch.linspace(0.0, 3.1416, batch_size, dtype=torch.float32)
    sampled = (torch.sin(grid + phase) + 1.0) / 2.0
    return (sampled * (t_max - 1) + 1).to(torch.int32)


def sample_timestep_beta(generator: Optional[torch.Generator],
                         batch_size: int, t_max: int, alpha: float = 2.0,
                         beta_param: float = 2.0,
                         device="cpu") -> torch.Tensor:
    """Beta(alpha, beta_param)-distributed timesteps in [0, t_max-1],
    int32. Drawn as X / (X + Y) with X, Y Gamma variates from the
    generator (``torch.distributions`` reads the global RNG)."""
    a = torch.full((batch_size,), float(alpha), device=device)
    b = torch.full((batch_size,), float(beta_param), device=device)
    x = torch._standard_gamma(a, generator=generator)
    y = torch._standard_gamma(b, generator=generator)
    return (x / (x + y) * (t_max - 1)).to(torch.int32)


def _entry(table: torch.Tensor, t) -> torch.Tensor:
    """``table[t]`` as a 0-d tensor, for an int ``t`` or a 0-d integer
    tensor (a gather, so an exported step holds no data-dependent index)."""
    if isinstance(t, int):
        return table[t]
    return table.index_select(0, t.reshape(1).long()).reshape(())


@dataclass
class DiffusionState:
    """UNet parameters (a state_dict), the optimizer's ``state_dict`` (None
    for a serving-only state) and the step count."""
    params: Dict[str, torch.Tensor]
    opt_state: Optional[Dict[str, Any]] = None
    step: int = 0


def _share_parameters(dst: nn.Module, src: nn.Module) -> None:
    """Make every parameter of ``dst`` the very tensor of ``src`` with the
    same name (the two modules then hold one set of parameters)."""
    for name, p in src.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(dst.get_submodule(owner), leaf, p)


class DiffusionTrainer:
    """DDPM training and sampling around one set of UNet parameters on
    ``device``."""

    def __init__(self, cfg: DiffusionConfig, img_shape: Tuple[int, int, int],
                 device="cuda", mesh: Mesh = LOCAL):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.img_shape = tuple(img_shape)
        c = img_shape[-1]
        kw = dict(in_ch=c, out_ch=c, base_ch=cfg.base_ch,
                  time_emb_dim=cfg.time_emb_dim, attention=cfg.attention,
                  dtype=DTYPES[cfg.run.compute_dtype])
        with torch.device(self.device):
            self.model = UNet(fused=False, **kw)
            self.model_fused = UNet(fused=True, **kw)
        _share_parameters(self.model_fused, self.model)
        self.model_fused.eval()
        if mesh.model > 1:
            self.model.sp_group = self.model_fused.sp_group = \
                mesh.model_group
        self.opt: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.sched = make_schedule(cfg.timesteps, cfg.beta_start,
                                   cfg.beta_end, device=self.device)
        # abar with a last entry 1 at index T: the DDIM step after the last
        # subsequence entry
        self.acp_ext = torch.cat([self.sched.alphas_cumprod,
                                  torch.ones(1, device=self.device)])

    def _optimizer(self) -> torch.optim.Optimizer:
        if self.opt is None:
            self.opt = adam(self.model.parameters(), self.cfg.lr,
                            capturable=True)
        return self.opt

    def init(self, generator: Optional[torch.Generator] = None
             ) -> DiffusionState:
        """Seeded Flax-default init of the UNet and a fresh Adam; returns
        the state."""
        self.model.init_parameters(generator)
        self.opt = None
        self.step = 0
        return DiffusionState(params=self.model.state_dict(),
                              opt_state=self._optimizer().state_dict())

    def load(self, state: DiffusionState) -> None:
        """Load a state's parameters into the UNet (strict), and its
        optimizer state when it has one."""
        self.model.load_state_dict(state.params, strict=True)
        if state.opt_state is not None:
            self._optimizer().load_state_dict(state.opt_state)
        self.step = int(state.step)

    # ------------------------------------------------------------------ train
    def _inputs(self, batch_uint8, generator, t, noise):
        """x_t, t and the noise of this rank's rows; t and noise are the
        global batch's, given or drawn in that order."""
        x0 = to_signed(batch_uint8.to(self.device))
        mesh = self.mesh
        if t is None:
            t = batch_draw(mesh, lambda s: sample_timestep_uniform(
                generator, s[0], self.cfg.timesteps, self.device),
                (x0.shape[0],))
        else:
            t = mesh.rows(t)
        if noise is None:
            noise = batch_draw(mesh, lambda s: torch.randn(
                s, generator=generator, device=self.device), x0.shape)
        else:
            noise = mesh.rows(noise)
        t = t.to(self.device)
        noise = noise.to(self.device, torch.float32)
        return q_sample(self.sched, x0, t, noise), t, noise

    def train_step(self, batch_uint8: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One epsilon-prediction step: t ~ U{0..T-1} and Gaussian noise
        (drawn in that order from ``generator`` unless given), MSE of the
        UNet's prediction, backward, one Adam update. Returns the loss as a
        0-d device tensor (no host read)."""
        self.model.train()
        xt, t, noise = self._inputs(batch_uint8, generator, t, noise)
        loss = mse(self.model(xt, t), noise)
        opt = self._optimizer()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        average_grads(self.model.parameters(), self.mesh.grad_group)
        opt.step()
        self.step += 1
        return mean_metrics({"loss": loss.detach()}, self.mesh)["loss"]

    @torch.no_grad()
    def eval_loss(self, batch_uint8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-sample validation epsilon-MSE of this rank's rows, through
        the training form of the UNet, so the caller can drop a final
        batch's padded rows (each row is independent: GroupNorm is per
        sample)."""
        xt, t, noise = self._inputs(batch_uint8, generator, t, noise)
        pred = self.model(xt, t)
        return torch.square(pred.float() - noise).mean(dim=(1, 2, 3))

    def _noise(self, noise, i, like, generator):
        if noise is not None:
            return noise[i].to(device=like.device, dtype=like.dtype)
        return torch.randn(like.shape, generator=generator,
                           device=like.device, dtype=like.dtype)

    # ---------------------------------------------------------------- sample
    def _eps(self, x, t):
        """The fused UNet's noise prediction at timestep ``t``, an int or,
        in an exported step (``io/export.py``), a 0-d integer tensor."""
        if isinstance(t, int):
            t_vec = torch.full((x.shape[0],), t, dtype=torch.int32,
                               device=x.device)
        else:
            t_vec = t.to(torch.int32).reshape(1).expand(x.shape[0])
        with trace.timed("vgd.sample.forward", "sample.forward_min_s",
                         least=True):
            return self.model_fused(x, t_vec)

    def ancestral_step(self, x: torch.Tensor, t, noise: torch.Tensor
                       ) -> torch.Tensor:
        """One step of the reverse chain at timestep ``t`` (an int, or a
        0-d integer tensor) with the Gaussian draw ``noise``: the update
        that ``ancestral_sample`` repeats and an exported step runs."""
        s = self.sched
        eps = self._eps(x, t)
        x_new = x - (1.0 - _entry(s.alphas, t)) / \
            _entry(s.sqrt_one_minus_alphas_cumprod, t) * eps
        x_new = x_new / torch.sqrt(_entry(s.alphas, t))
        return x_new + noise * torch.sqrt(_entry(s.posterior_variance, t))

    def ddim_step(self, x: torch.Tensor, tau, tau_prev,
                  eta: torch.Tensor, noise: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """One DDIM step from ``tau`` to ``tau_prev`` (ints, or 0-d integer
        tensors; ``tau_prev`` = T after the last entry, where abar = 1),
        with ``sigma * noise`` added when ``noise`` is given: the update
        that ``ddim_sample`` repeats and an exported step runs."""
        at = _entry(self.acp_ext, tau)
        ap = _entry(self.acp_ext, tau_prev)
        eps = self._eps(x, tau)
        x0 = (x - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        sigma = eta * torch.sqrt((1.0 - ap) / (1.0 - at)) * \
            torch.sqrt(1.0 - at / ap)
        dir_c = torch.sqrt(torch.clamp(1.0 - ap - sigma * sigma, min=0.0))
        x = torch.sqrt(ap) * x0 + dir_c * eps
        return x if noise is None else x + sigma * noise

    @torch.inference_mode()
    def ancestral_sample(self, xt: torch.Tensor, t_start: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
        """Reverse chain from ``t_start`` down to 0, clipped to [-1, 1].

        The JAX package runs all T steps and masks those above ``t_start``
        (one compiled program whatever the start step); a masked step leaves
        x unchanged, so skipping it gives the identical result, and eager
        PyTorch has no reason to pay for masked forwards. ``noise`` holds
        one tensor per executed step, for t = t_start, ..., 0."""
        with trace.span("vgd.sample.request"):
            x = xt.to(self.device, torch.float32)
            for i, t in enumerate(range(int(t_start), -1, -1)):
                with trace.span("vgd.sample.step"):
                    x = self.ancestral_step(x, t, self._noise(noise, i, x,
                                                              generator))
            return torch.clamp(x, -1.0, 1.0)

    @torch.inference_mode()
    def ddim_sample(self, xt: torch.Tensor, num_steps: int, eta: float = 1.0,
                    t_start: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
        """DDIM over the strided subsequence ``ddim_timesteps``; the step
        after the last sees abar = 1. Subsequence entries above ``t_start``
        (default T-1) are skipped, as the JAX package masks them. With
        ``eta == 0`` the chain draws no noise. ``noise`` holds one tensor
        per executed step."""
        T = self.cfg.timesteps
        t_start = T - 1 if t_start is None else int(t_start)
        taus = [int(t) for t in ddim_timesteps(T, num_steps)[::-1]]
        eta_t = torch.tensor(eta, dtype=torch.float32, device=self.device)
        with trace.span("vgd.sample.request"):
            x = xt.to(self.device, torch.float32)
            i = 0
            for tau, tau_prev in zip(taus, taus[1:] + [T]):
                if tau > t_start:
                    continue
                with trace.span("vgd.sample.step"):
                    x = self.ddim_step(
                        x, tau, tau_prev, eta_t, None if eta == 0.0
                        else self._noise(noise, i, x, generator))
                i += 1
            return torch.clamp(x, -1.0, 1.0)

    def generate_ddim(self, shape: Tuple[int, ...], num_steps: int,
                      eta: float = 0.0,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Unconditional generation through the strided DDIM chain."""
        xt = torch.randn(shape, generator=generator, device=self.device)
        return self.ddim_sample(xt, num_steps, eta, generator=generator)

    @torch.inference_mode()
    def predict_x0(self, xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """One-step x0 estimate, clipped to [-1, 1]."""
        s = self.sched
        xt = xt.to(self.device, torch.float32)
        t = t.to(self.device)
        pred = self.model_fused(xt, t)
        t = t.long()
        a = s.sqrt_alphas_cumprod[t][:, None, None, None]
        b = s.sqrt_one_minus_alphas_cumprod[t][:, None, None, None]
        return torch.clamp((xt - b * pred) / a, -1.0, 1.0)

    def generate(self, shape: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Unconditional generation from pure noise (full ancestral chain)."""
        xt = torch.randn(shape, generator=generator, device=self.device)
        return self.ancestral_sample(xt, self.cfg.timesteps - 1, generator)
