"""Command line of the port (``vgd_tpu/cli.py``), DDPM and VAE-GAN:

  python -m vgd_tpu_torch.cli diffusion --epochs 100 --out-dir runs/diffusion \\
      [--steps-per-epoch 8] [--resume] [--profile-dir runs/diffusion/trace]
  python -m vgd_tpu_torch.cli sample --family diffusion --out-dir runs/diffusion \\
      [-n 16] [--ddim-steps 50 --ddim-eta 0.0]
  python -m vgd_tpu_torch.cli eval-diffusion --out-dir runs/diffusion [--max-batches 1]
  python -m vgd_tpu_torch.cli vaegan --image-size 256 --batch-size 64 \\
      --out-dir runs/vaegan [--epochs 150] [--steps-per-epoch 9] \\
      [--fused-conv] [--resume] [--profile-dir runs/vaegan/trace]
  python -m vgd_tpu_torch.cli sample --family vaegan --out-dir runs/vaegan \\
      --image-size 256 [-n 64]
  python -m vgd_tpu_torch.cli glow --iters 30000 --out-dir runs/glow \\
      [--fused-coupling] [--sample-every 100] [--checkpoint-every 1000] \\
      [--resume] [--profile-dir runs/glow/trace]
  python -m vgd_tpu_torch.cli sample --family glow --out-dir runs/glow [-n 20]
  python -m vgd_tpu_torch.cli eval-glow --out-dir runs/glow [--max-batches 1]

``diffusion``, ``vaegan`` and ``glow`` train (``train.loop.run_diffusion``
/ ``run_vaegan`` / ``run_glow``) and write ``<out-dir>/ckpt``; ``sample``,
``eval-diffusion`` and ``eval-glow`` restore it. All run on ``--device
cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from vgd_tpu_torch.core import config as C


def _add_common(p, serving=True):
    p.add_argument("--out-dir", type=str, default=None,
                   help="default: the family's config (runs/<family>)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--dataset-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    if serving:
        p.add_argument("--step", type=int, default=None,
                       help="checkpoint step (default: latest)")
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])


def _add_diffusion(p):
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--no-attn", action="store_true")


def _add_glow(p):
    p.add_argument("--n-flows", type=int, default=None, help="K (32)")
    p.add_argument("--n-blocks", type=int, default=None, help="L (4)")
    p.add_argument("--filter-size", type=int, default=None,
                   help="coupling width (512)")
    p.add_argument("--fused-coupling", action="store_true",
                   help="Glow: the coupling networks through the K5 kernels")
    p.add_argument("--flow-stack", action="store_true",
                   help="Glow: whole flow chains per kernel (K6, not ported "
                   "yet: raises)")


def _add_training(p):
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="truncate epochs (smoke runs)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="torch.profiler trace of train steps 10-20 here")


def _with_args(cfg, a, **run):
    """``cfg`` with the values given on the command line."""
    data = {k: getattr(a, k) for k in ("batch_size", "dataset_size")
            if getattr(a, k) is not None}
    if a.image_size is not None:
        data["image_size"] = (a.image_size, a.image_size)
    run["seed"] = a.seed
    for k in ("out_dir", "compute_dtype", "profile_dir", "keep_checkpoints"):
        if getattr(a, k, None) is not None:
            run[k] = getattr(a, k)
    top = {k: getattr(a, k) for k in ("epochs", "lr")
           if getattr(a, k, None) is not None}
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                               run=dataclasses.replace(cfg.run, **run), **top)


def _diffusion_cfg(a) -> C.DiffusionConfig:
    return _with_args(C.DiffusionConfig(timesteps=a.timesteps,
                                        attention=not a.no_attn), a)


def _vaegan_cfg(a) -> C.VAEGANConfig:
    return _with_args(C.VAEGANConfig(), a,
                      fused_conv=bool(getattr(a, "fused_conv", False)))


def _glow_cfg(a) -> C.GlowConfig:
    run = {k: getattr(a, arg) for k, arg in (
        ("sample_every_iters", "sample_every"),
        ("checkpoint_every_iters", "checkpoint_every"))
        if getattr(a, arg, None) is not None}
    sizes = {k: getattr(a, k) for k in ("n_flows", "n_blocks", "filter_size")
             if getattr(a, k, None) is not None}
    return _with_args(C.GlowConfig(
        fused_coupling=bool(getattr(a, "fused_coupling", False)),
        flow_stack=bool(getattr(a, "flow_stack", False)), **sizes), a, **run)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vgd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("diffusion", help="train DDPM (checkpoints under "
                       "<out-dir>/ckpt, loss log diffusion_loss.jsonl)")
    _add_common(p, serving=False)
    _add_diffusion(p)
    _add_training(p)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--keep-checkpoints", type=int, default=None)

    p = sub.add_parser("vaegan", help="train the VAE-GAN (checkpoints under "
                       "<out-dir>/ckpt, loss log vaegan_loss.jsonl)")
    _add_common(p, serving=False)
    _add_training(p)
    p.add_argument("--fused-conv", action="store_true",
                   help="encoder/discriminator Conv+BN+LeakyReLU through "
                   "the fused K1 kernel")

    p = sub.add_parser("glow", help="train Glow (checkpoints under "
                       "<out-dir>/ckpt, loss log glow_loss.jsonl)")
    _add_common(p, serving=False)
    _add_glow(p)
    p.add_argument("--iters", type=int, default=None,
                   help="iterations (default: the config's 30000)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="torch.profiler trace of train steps 10-20 here")
    p.add_argument("--sample-every", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)

    p = sub.add_parser("eval-glow", help="temperature-sample SSIM of a "
                       "Glow checkpoint against the val split")
    _add_common(p)
    _add_glow(p)
    p.add_argument("--max-batches", type=int, default=None)

    p = sub.add_parser("sample", help="sample grid from a checkpoint")
    _add_common(p)
    _add_diffusion(p)
    _add_glow(p)
    p.add_argument("--family", required=True,
                   choices=["diffusion", "vaegan", "glow"])
    p.add_argument("-n", "--num-samples", type=int, default=64)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--ddim-steps", type=int, default=0,
                   help=">0 samples through the strided DDIM chain instead "
                   "of the full ancestral chain")
    p.add_argument("--ddim-eta", type=float, default=0.0)

    p = sub.add_parser("eval-diffusion", help="partial-noise restoration "
                       "evaluation (PSNR, MSE) of a checkpoint")
    _add_common(p)
    _add_diffusion(p)
    p.add_argument("--max-batches", type=int, default=None)

    a = ap.parse_args(argv)
    from vgd_tpu_torch.train import loop as L

    if a.cmd == "glow":
        L.run_glow(_glow_cfg(a), n_iter=a.iters, resume=a.resume,
                   device=a.device)
        return 0
    if a.cmd == "eval-glow":
        res = L.evaluate_glow_from_dir(_glow_cfg(a), max_batches=a.max_batches,
                                       step=a.step, device=a.device)
        print(json.dumps(res))
        return 0
    if a.cmd == "sample" and a.family == "glow":
        L.sample_from_dir("glow", _glow_cfg(a), n=a.num_samples,
                          out_path=a.out, step=a.step, seed=a.seed,
                          device=a.device)
        return 0
    if a.cmd == "vaegan":
        L.run_vaegan(_vaegan_cfg(a), max_steps_per_epoch=a.steps_per_epoch,
                     resume=a.resume, device=a.device)
        return 0
    if a.cmd == "sample" and a.family == "vaegan":
        L.sample_from_dir("vaegan", _vaegan_cfg(a), n=a.num_samples,
                          out_path=a.out, step=a.step, seed=a.seed,
                          device=a.device)
        return 0
    cfg = _diffusion_cfg(a)
    if a.cmd == "diffusion":
        L.run_diffusion(cfg, max_steps_per_epoch=a.steps_per_epoch,
                        resume=a.resume, device=a.device)
    elif a.cmd == "sample":
        L.sample_from_dir(a.family, cfg, n=a.num_samples, out_path=a.out,
                          step=a.step, seed=a.seed, ddim_steps=a.ddim_steps,
                          ddim_eta=a.ddim_eta, device=a.device)
    else:
        res = L.evaluate_diffusion_from_dir(cfg, max_batches=a.max_batches,
                                            step=a.step, device=a.device)
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
