"""Typed configuration for the ported workloads.

Own copies of ``vgd_tpu/core/config.py``'s ``DataConfig``, ``RunConfig``,
``VAEGANConfig``, ``GANConfig``, ``VAEConfig``, ``GlowConfig``,
``GlowEEGConfig`` and ``DiffusionConfig`` with the same defaults (a test pins them field by field). ``RunConfig`` keeps only the
fields the ported paths read; ``compute_dtype``/``param_dtype`` keep their
meaning: convs and dense layers compute in ``compute_dtype``, parameters
are stored in ``param_dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """CelebA(-HQ) pipeline."""
    path: Optional[str] = None          # folder of *.jpg; None => synthetic data
    image_size: Tuple[int, int] = (64, 64)
    channels: int = 3
    batch_size: int = 64
    train_fraction: float = 0.9
    dataset_size: Optional[int] = None
    noise_max_std: Optional[float] = None
    occlusion: bool = True
    normalize: bool = True              # True => [-1,1]; False => [0,1]
    prefetch: int = 2


@dataclass(frozen=True)
class RunConfig:
    """Run knobs the ported serving and training paths read."""
    seed: int = 42
    out_dir: str = "runs/default"
    checkpoint_every_epochs: int = 1
    checkpoint_every_iters: int = 1000   # iteration-driven trainers (Glow)
    sample_every_iters: int = 100
    keep_checkpoints: int = 3
    compute_dtype: str = "bfloat16"      # conv/matmul compute dtype
    param_dtype: str = "float32"
    # torch.profiler trace of train steps [start, stop) into this directory
    profile_dir: Optional[str] = None
    profile_steps: Tuple[int, int] = (10, 20)
    # fused Conv4x4s2 + BatchNorm + LeakyReLU (K1) in the encoder and
    # discriminator train paths; off by default, as in the JAX package
    fused_conv: bool = False
    # the run_* loops under torch.autograd.set_detect_anomaly (the
    # counterpart of jax_debug_nans): a backward that makes a NaN raises
    debug_nans: bool = False


@dataclass(frozen=True)
class VAEGANConfig:
    """The flagship VAE-GAN (reference vaegan_code.py scale: latent 100,
    three Adams at lr 2e-4, 150 epochs)."""
    data: DataConfig = field(default_factory=DataConfig)
    run: RunConfig = field(default_factory=lambda: RunConfig(out_dir="runs/vaegan"))
    latent_dim: int = 100
    epochs: int = 150
    lr: float = 2e-4
    alpha_kl: float = 0.1
    alpha_adv: float = 0.1
    kl_warmup_epochs: int = 50          # KL ramp min(1, epoch / 50)
    label_real: float = 0.9             # label smoothing
    label_fake: float = 0.1
    instance_noise: float = 0.05        # std of the noise on D inputs
    d_steps: int = 2                    # discriminator steps per batch
    ngf: int = 64
    ndf: int = 64
    recon_loss: str = "pixel"           # "pixel" | "disl" (D-feature MSE)
    val_noise_std: float = 0.05


@dataclass(frozen=True)
class GANConfig:
    """DCGAN / WGAN (reference gan_code.py scale: batch 128, Adam at lr
    2e-4 with betas (0.5, 0.999), 150 epochs; WGAN: 5 critic iterations,
    critic weights clipped to +-0.01)."""
    data: DataConfig = field(default_factory=lambda: DataConfig(batch_size=128))
    run: RunConfig = field(default_factory=lambda: RunConfig(out_dir="runs/gan"))
    latent_dim: int = 100
    # the CLI's `wgan` command defaults to the reference's 1500 epochs
    epochs: int = 150
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    ngf: int = 64
    ndf: int = 64
    wgan: bool = False
    clip_value: float = 0.01
    critic_iters: int = 5


@dataclass(frozen=True)
class VAEConfig:
    """The denoising VAE (reference main_vae.py: one joint Adam at lr 1e-3,
    KL weight 1e-5 on a 50-epoch ramp, training noise std 0.5)."""
    data: DataConfig = field(default_factory=lambda: DataConfig(
        noise_max_std=0.5, occlusion=False))
    run: RunConfig = field(default_factory=lambda: RunConfig(out_dir="runs/vae"))
    latent_dim: int = 100
    epochs: int = 100
    lr: float = 1e-3
    kl_weight: float = 1e-5
    kl_warmup_epochs: int = 50
    ngf: int = 64


def check_flow_stack(flow_stack) -> None:
    """``flow_stack`` is False, True or a positive int (an h*w threshold)."""
    if not (isinstance(flow_stack, bool) or (
            isinstance(flow_stack, int) and flow_stack > 0)):
        raise ValueError(f"flow_stack must be False, True or a positive int "
                         f"(the squeezed h*w up to which a block runs K6), "
                         f"got {flow_stack!r}")


@dataclass(frozen=True)
class GlowConfig:
    """Glow on images at the reference's training scale (64x64, batch 16,
    K=32 flows, L=4 blocks, coupling width 512, 5 bits, 30k iterations),
    bf16 coupling convs. Left out: ``remat``, ``pp_stages`` /
    ``pp_microbatches`` and ``scan_unroll`` (the last has no meaning without
    ``lax.scan``)."""
    data: DataConfig = field(default_factory=lambda: DataConfig(
        batch_size=16, normalize=False))
    run: RunConfig = field(default_factory=lambda: RunConfig(
        out_dir="runs/glow", compute_dtype="bfloat16"))
    n_bits: int = 5
    n_flows: int = 32                   # K
    n_blocks: int = 4                   # L
    filter_size: int = 512              # coupling width
    n_iter: int = 30000
    lr: float = 1e-4
    temperature: float = 0.7
    n_samples: int = 20
    # the coupling network through K5 (ops/glow_coupling.py); off by
    # default, as in the JAX package
    fused_coupling: bool = False
    # a block's whole flow chain through K6 (ops/glow_flow_stack.py): True
    # = every block, an int N = the blocks whose squeezed h*w <= N; off by
    # default, as in the JAX package
    flow_stack: "bool | int" = False

    def __post_init__(self):
        check_flow_stack(self.flow_stack)


@dataclass(frozen=True)
class GlowEEGConfig:
    """1-D Glow on EEG trials at the reference's scale (flow_eeg.py: 22
    channels x 160 samples, batch 16, K=32, L=4, width 512, Adam at 1e-3,
    6000 iterations, temperature 0.7), f32 couplings. As in the JAX
    package it has no ``fused_coupling`` or ``flow_stack`` option."""
    run: RunConfig = field(default_factory=lambda: RunConfig(
        out_dir="runs/glow_eeg", compute_dtype="float32"))
    # folder of BCI-IV-2a .npz; None => synthetic trials
    eeg_path: Optional[str] = None
    num_channels: int = 22
    num_samples: int = 160              # 640 samples decimated x4
    batch_size: int = 16
    n_flows: int = 32
    n_blocks: int = 4
    filter_size: int = 512
    n_iter: int = 6000
    lr: float = 1e-3
    temperature: float = 0.7
    event_type: str = "mi"              # "mi" | "baseline"
    n_samples: int = 16


@dataclass(frozen=True)
class DiffusionConfig:
    """DDPM at the reference's training scale (256x256, batch 16)."""
    data: DataConfig = field(default_factory=lambda: DataConfig(
        batch_size=16, image_size=(256, 256)))
    run: RunConfig = field(default_factory=lambda: RunConfig(out_dir="runs/diffusion"))
    epochs: int = 100
    lr: float = 2e-4
    timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    base_ch: int = 64
    time_emb_dim: int = 256
    attention: bool = True


def to_dict(cfg) -> dict:
    """Plain nested dict of a config (checkpoint metadata)."""
    return dataclasses.asdict(cfg)
