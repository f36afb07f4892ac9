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
when to read them.

The samplers run eagerly under ``torch.inference_mode()``, one UNet
forward per step. Scalar schedule entries stay 0-d f32 tensors on the
device, so the update arithmetic is f32 as in the JAX package and no step
waits on the host. Each sampler draws its Gaussian noise from an explicit
``torch.Generator``, or takes a ``noise`` sequence of one tensor per
executed step, so a test can hand both packages the same draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vgd_tpu_torch.core.config import DiffusionConfig
from vgd_tpu_torch.core.rng import resolve_device
from vgd_tpu_torch.models.unet import UNet
from vgd_tpu_torch.ops.image import to_signed
from vgd_tpu_torch.train.common import DTYPES, adam, mse



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
    """Linear beta schedule and its derived quantities, in f32."""
    betas = torch.linspace(start, end, timesteps, dtype=torch.float32,
                           device=device)
    alphas = 1.0 - betas
    acp = torch.cumprod(alphas, dim=0)
    acp_prev = torch.cat([torch.ones(1, dtype=torch.float32, device=device),
                          acp[:-1]])
    return Schedule(
        betas=betas, alphas=alphas, alphas_cumprod=acp,
        alphas_cumprod_prev=acp_prev,
        sqrt_alphas_cumprod=torch.sqrt(acp),
        sqrt_one_minus_alphas_cumprod=torch.sqrt(1.0 - acp),
        posterior_variance=betas * (1.0 - acp_prev) / (1.0 - acp))


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
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
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
        self.opt: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.sched = make_schedule(cfg.timesteps, cfg.beta_start,
                                   cfg.beta_end, device=self.device)

    def _optimizer(self) -> torch.optim.Optimizer:
        if self.opt is None:
            self.opt = adam(self.model.parameters(), self.cfg.lr)
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
        x0 = to_signed(batch_uint8.to(self.device))
        if t is None:
            t = sample_timestep_uniform(generator, x0.shape[0],
                                        self.cfg.timesteps, self.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=self.device)
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
        opt.step()
        self.step += 1
        return loss.detach()

    def train_epoch(self, batches: Iterable[torch.Tensor],
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """``train_step`` over every batch; the mean loss as a 0-d device
        tensor."""
        total, count = None, 0
        for batch in batches:
            loss = self.train_step(batch, generator)
            total = loss if total is None else total + loss
            count += 1
        if total is None:
            raise ValueError("train_epoch got no batch")
        return total / count

    @torch.no_grad()
    def eval_loss(self, batch_uint8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-sample validation epsilon-MSE (B,), through the training
        form of the UNet, so the caller can drop a final batch's padded
        rows (each row is independent: GroupNorm is per sample)."""
        xt, t, noise = self._inputs(batch_uint8, generator, t, noise)
        pred = self.model(xt, t)
        return torch.square(pred.float() - noise).mean(dim=(1, 2, 3))

    def _noise(self, noise, i, like, generator):
        if noise is not None:
            return noise[i].to(device=like.device, dtype=like.dtype)
        return torch.randn(like.shape, generator=generator,
                           device=like.device, dtype=like.dtype)

    # ---------------------------------------------------------------- sample
    def _eps(self, x, t: int):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.int32,
                           device=x.device)
        return self.model_fused(x, t_vec)

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
        s = self.sched
        x = xt.to(self.device, torch.float32)
        for i, t in enumerate(range(int(t_start), -1, -1)):
            eps = self._eps(x, t)
            x_new = x - (1.0 - s.alphas[t]) / \
                s.sqrt_one_minus_alphas_cumprod[t] * eps
            x_new = x_new / torch.sqrt(s.alphas[t])
            x = x_new + self._noise(noise, i, x, generator) * \
                torch.sqrt(s.posterior_variance[t])
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
        acp = self.sched.alphas_cumprod
        t_start = T - 1 if t_start is None else int(t_start)
        taus = ddim_timesteps(T, num_steps)[::-1]
        taus_prev = list(taus[1:]) + [None]
        one = torch.ones((), dtype=torch.float32, device=self.device)
        eta_t = torch.tensor(eta, dtype=torch.float32, device=self.device)
        x = xt.to(self.device, torch.float32)
        i = 0
        for tau, tau_prev in zip(taus, taus_prev):
            if tau > t_start:
                continue
            at = acp[int(tau)]
            ap = one if tau_prev is None else acp[int(tau_prev)]
            eps = self._eps(x, int(tau))
            x0 = (x - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
            sigma = eta_t * torch.sqrt((1.0 - ap) / (1.0 - at)) * \
                torch.sqrt(1.0 - at / ap)
            dir_c = torch.sqrt(torch.clamp(1.0 - ap - sigma * sigma, min=0.0))
            x = torch.sqrt(ap) * x0 + dir_c * eps
            if eta != 0.0:
                x = x + sigma * self._noise(noise, i, x, generator)
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
