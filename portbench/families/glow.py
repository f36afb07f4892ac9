"""The program under test for Glow: ``vgd_tpu_torch``'s ``GlowTrainer``
on the benchmark's weights and buffers, with the run's generator seeded as
``train.loop._start`` seeds it, trained as ``train.loop.run_glow`` trains
it (the ActNorm init on the stream's first batch, then one
``train_step`` a batch through ``train.loop._glow_steps``)."""
from __future__ import annotations

from vgd_tpu_torch.core.config import DataConfig, GlowConfig, RunConfig
from vgd_tpu_torch.core.rng import seed_all
from vgd_tpu_torch.parallel.mesh import LOCAL
from vgd_tpu_torch.train.glow import GlowTrainer


def program_config(cfg: dict, seed: int) -> GlowConfig:
    s = cfg["image_size"]
    return GlowConfig(
        data=DataConfig(image_size=(s, s), channels=cfg["channels"],
                        batch_size=cfg["batch_size"],
                        train_fraction=cfg["train_fraction"],
                        dataset_size=cfg["dataset_size"], normalize=False),
        run=RunConfig(seed=seed, compute_dtype=cfg["compute_dtype"],
                      param_dtype=cfg["param_dtype"]),
        n_bits=cfg["n_bits"], n_flows=cfg["n_flows"],
        n_blocks=cfg["n_blocks"], filter_size=cfg["filter_size"],
        lr=cfg["lr"], fused_coupling=cfg["fused_coupling"],
        flow_stack=cfg["flow_stack"])


class TrainSystem:
    """The trainer with the weights (``state_dict`` names, buffers
    included, copied in) and the run's generator."""

    def __init__(self, cfg: dict, image_shape, params, seed: int, device):
        self.trainer = GlowTrainer(program_config(cfg, seed), image_shape,
                                   device=device, mesh=LOCAL)
        self.trainer.load({k: v.clone() for k, v in params.items()})
        self.generator = seed_all(seed, device)

    def init_step(self, batch) -> None:
        self.trainer.init_step(batch, self.generator)

    def leaves(self):
        return dict(self.trainer.model.named_parameters())

    def optimizers(self):
        return [self.trainer.opt]
