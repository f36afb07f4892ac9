"""The program under test for DDPM: ``vgd_tpu_torch``'s
``DiffusionTrainer`` on the benchmark's weights, with the step function
that ``train.loop.run_diffusion`` gives its epoch scan (the run's
generator), and its DDIM sampler as ``train.loop.sample_from_dir`` runs
it."""
from __future__ import annotations

import torch

from vgd_tpu_torch.core.config import DataConfig, DiffusionConfig, RunConfig
from vgd_tpu_torch.core.rng import seed_all
from vgd_tpu_torch.parallel.mesh import LOCAL
from vgd_tpu_torch.train.diffusion import DiffusionState, DiffusionTrainer


def program_config(cfg: dict, seed: int) -> DiffusionConfig:
    s = cfg["image_size"]
    return DiffusionConfig(
        data=DataConfig(image_size=(s, s), channels=cfg["channels"],
                        batch_size=cfg["batch_size"],
                        train_fraction=cfg["train_fraction"],
                        dataset_size=cfg["dataset_size"]),
        run=RunConfig(seed=seed, compute_dtype=cfg["compute_dtype"],
                      param_dtype=cfg["param_dtype"]),
        lr=cfg["lr"], timesteps=cfg["timesteps"],
        beta_start=cfg["beta_start"], beta_end=cfg["beta_end"],
        base_ch=cfg["base_ch"], time_emb_dim=cfg["time_emb_dim"],
        attention=cfg["attention"])


def trainer(cfg: dict, params, seed: int, device) -> DiffusionTrainer:
    """The trainer with ``params`` (copied in) and no optimizer state."""
    s = cfg["image_size"]
    tr = DiffusionTrainer(program_config(cfg, seed),
                          (s, s, cfg["channels"]), device=device, mesh=LOCAL)
    tr.load(DiffusionState(params={k: v.clone() for k, v in params.items()}))
    return tr


class TrainSystem:
    """The trainer, its step function and the run's generator."""

    def __init__(self, cfg: dict, image_shape, params, seed: int, device):
        self.trainer = trainer(cfg, params, seed, device)
        self.generator = seed_all(seed, device)

    def step_fn(self, batch):
        # the tensor the step reads its batch from (on a card, from the
        # capture on, the step graph's input slot), for the check
        self.seen = batch
        return {"loss": self.trainer.train_step(batch, self.generator)}

    def start_epoch(self, epoch: int) -> None:
        pass

    def leaves(self):
        return dict(self.trainer.model.named_parameters())

    def optimizers(self):
        return [self.trainer._optimizer()]


def sampler(cfg: dict, params, seed: int, device):
    """``request(x_t, steps, eta)``: the images of one DDIM request on the
    host, and the fused UNet the requests run (for the check's hook)."""
    tr = trainer(cfg, params, seed, device)

    def request(x_t, steps: int, eta: float):
        return tr.ddim_sample(x_t, steps, eta=eta).cpu()
    return request, tr.model_fused
