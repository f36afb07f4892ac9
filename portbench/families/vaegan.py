"""The program under test for the VAE-GAN: ``vgd_tpu_torch``'s
``VAEGANTrainer`` with the step function that ``train.loop.run_vaegan``
gives its epoch scan (the KL ramp a 0-d tensor filled each epoch, the
run's generator), on the benchmark's weights."""
from __future__ import annotations

import torch

from vgd_tpu_torch.core.config import DataConfig, RunConfig, VAEGANConfig
from vgd_tpu_torch.core.rng import seed_all
from vgd_tpu_torch.parallel.mesh import LOCAL
from vgd_tpu_torch.train.vaegan import VAEGANTrainer


def program_config(cfg: dict, seed: int) -> VAEGANConfig:
    s = cfg["image_size"]
    return VAEGANConfig(
        data=DataConfig(image_size=(s, s), channels=cfg["channels"],
                        batch_size=cfg["batch_size"],
                        train_fraction=cfg["train_fraction"],
                        dataset_size=cfg["dataset_size"]),
        run=RunConfig(seed=seed, compute_dtype=cfg["compute_dtype"],
                      param_dtype=cfg["param_dtype"],
                      fused_conv=cfg["fused_conv"]),
        latent_dim=cfg["latent_dim"], lr=cfg["lr"], alpha_kl=cfg["alpha_kl"],
        alpha_adv=cfg["alpha_adv"],
        kl_warmup_epochs=cfg["kl_warmup_epochs"],
        label_real=cfg["label_real"], label_fake=cfg["label_fake"],
        instance_noise=cfg["instance_noise"], d_steps=cfg["d_steps"],
        ngf=cfg["ngf"], ndf=cfg["ndf"])


class TrainSystem:
    """The trainer on ``params`` (copied in), its step function and the
    run's generator, seeded as ``train.loop._start`` seeds it."""

    def __init__(self, cfg: dict, image_shape, params, seed: int, device):
        self.trainer = VAEGANTrainer(program_config(cfg, seed), image_shape,
                                     device=device, mesh=LOCAL)
        self.trainer.load({k: v.clone() for k, v in params.items()})
        self.generator = seed_all(seed, device)
        self.ramp = torch.zeros((), device=device)

    def step_fn(self, batch):
        # the tensor the step reads its batch from (on a card, from the
        # capture on, the step graph's input slot), for the check
        self.seen = batch
        return self.trainer.train_step(batch, self.ramp, self.generator)

    def start_epoch(self, epoch: int) -> None:
        self.ramp.fill_(self.trainer.kl_ramp(epoch))

    def leaves(self):
        """The trained parameters by ``state_dict`` name."""
        return {f"{net}.{k}": p for net, m in self.trainer.nets().items()
                for k, p in m.named_parameters()}

    def optimizers(self):
        return list(self.trainer.opts.values())
