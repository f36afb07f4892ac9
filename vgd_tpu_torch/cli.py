"""Command line of the port (``vgd_tpu/cli.py``), DDPM, VAE-GAN, the
denoising VAE, DCGAN / WGAN and Glow:

  python -m vgd_tpu_torch.cli diffusion --epochs 100 --out-dir runs/diffusion \\
      [--steps-per-epoch 8] [--resume] [--profile-dir runs/diffusion/trace]
  python -m vgd_tpu_torch.cli sample --family diffusion --out-dir runs/diffusion \\
      [-n 16] [--ddim-steps 50 --ddim-eta 0.0]
  python -m vgd_tpu_torch.cli eval-diffusion --out-dir runs/diffusion [--max-batches 1]
  python -m vgd_tpu_torch.cli vaegan --image-size 256 --batch-size 64 \\
      --out-dir runs/vaegan [--epochs 150] [--steps-per-epoch 9] \\
      [--fused-conv] [--lr 2e-4] [--keep-checkpoints 3] [--resume] \\
      [--profile-dir runs/vaegan/trace]
  python -m vgd_tpu_torch.cli sample --family vaegan --out-dir runs/vaegan \\
      --image-size 256 [-n 64]
  python -m vgd_tpu_torch.cli glow --iters 30000 --out-dir runs/glow \\
      [--fused-coupling] [--flow-stack [N]] [--sample-every 100] \\
      [--checkpoint-every 1000] [--lr 1e-4] [--keep-checkpoints 3] \\
      [--resume] [--profile-dir runs/glow/trace]
  python -m vgd_tpu_torch.cli sample --family glow --out-dir runs/glow [-n 20]
  python -m vgd_tpu_torch.cli eval-glow --out-dir runs/glow [--max-batches 1]
  python -m vgd_tpu_torch.cli vae --epochs 100 [--noise-std 0.5] [--occlusion] \
      [--fused-conv] [--steps-per-epoch 9] [--resume]
  python -m vgd_tpu_torch.cli eval-vae --out-dir runs/vae [--occlusion] \
      [--max-checkpoints 1] [--max-batches 1] [--step 3]
  python -m vgd_tpu_torch.cli sample --family vae --out-dir runs/vae [-n 64]
  python -m vgd_tpu_torch.cli denoise --ckpt runs/vae/ckpt --input img.jpg \
      [--output denoised.png] [--image-size 64]
  python -m vgd_tpu_torch.cli gan|wgan [--epochs N] [--fused-conv] [--resume]
  python -m vgd_tpu_torch.cli eval-gan --out-dir runs/gan [--wgan] \
      [--max-checkpoints 1]
  python -m vgd_tpu_torch.cli sample --family gan|wgan --out-dir runs/gan

``diffusion``, ``vaegan``, ``vae``, ``gan``, ``wgan`` and ``glow`` train
(``train.loop.run_diffusion`` / ``run_vaegan`` / ``run_vae`` / ``run_gan``
/ ``run_glow``) and write ``<out-dir>/ckpt``; ``sample``, the ``eval-*``
commands and ``denoise`` restore it. ``wgan`` trains 1500 epochs unless
``--epochs`` says otherwise (the reference's scale). ``denoise`` reads an
image file or every ``*.jpg`` of a folder with PIL (imported there only)
and writes the restorations as images. All run on ``--device cuda`` unless
``--device cpu`` is given.
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
    p.add_argument("--flow-stack", nargs="?", const="all", default=None,
                   metavar="POSITIONS",
                   help="Glow: each block's whole flow chain through the K6 "
                   "kernel (one launch per block and direction); bare flag "
                   "= every block, an int N = only the blocks whose "
                   "squeezed h*w <= N")


def _add_vae(p):
    p.add_argument("--noise-std", type=float, default=None,
                   help="VAE: corruption noise std (default 0.5)")


def _add_training(p):
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="truncate epochs (smoke runs)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="torch.profiler trace of train steps 10-20 here")


def _add_optim(p):
    """The training commands' --lr and --keep-checkpoints (each command of
    the reference takes both)."""
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default: the config's)")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="checkpoint retention count (default 3)")


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


def _vae_cfg(a) -> C.VAEConfig:
    cfg = _with_args(C.VAEConfig(), a,
                     fused_conv=bool(getattr(a, "fused_conv", False)))
    data = {"occlusion": bool(getattr(a, "occlusion", False))}
    if getattr(a, "noise_std", None) is not None:
        data["noise_max_std"] = a.noise_std
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                             **data))


def _gan_cfg(a, wgan: bool) -> C.GANConfig:
    cfg = C.GANConfig(wgan=wgan)
    if wgan:
        cfg = dataclasses.replace(cfg, epochs=1500,
                                  run=dataclasses.replace(cfg.run,
                                                          out_dir="runs/wgan"))
    return _with_args(cfg, a, fused_conv=bool(getattr(a, "fused_conv",
                                                      False)))


def _denoise(a) -> None:
    """``denoise``: decode the inputs with PIL, restore them through
    ``train.loop.denoise_images``, write each as an image."""
    import glob
    import os

    import numpy as np
    from PIL import Image
    from vgd_tpu_torch.train import loop as L

    size = (a.image_size, a.image_size)
    cfg = dataclasses.replace(C.VAEConfig(), data=C.DataConfig(
        image_size=size), run=dataclasses.replace(
            C.VAEConfig().run, compute_dtype=a.compute_dtype or "bfloat16"))
    paths = ([a.input] if os.path.isfile(a.input)
             else sorted(glob.glob(os.path.join(a.input, "*.jpg"))))
    if not paths:
        raise SystemExit(f"no image at {a.input}")
    imgs = np.stack([np.asarray(Image.open(p).convert("RGB").resize(size))
                     for p in paths])
    out = L.denoise_images(cfg, a.ckpt, imgs, seed=a.seed, device=a.device)
    for p, img in zip(paths, out):
        dst = (a.output if len(paths) == 1 else
               os.path.join(os.path.dirname(a.output) or ".",
                            f"denoised_{os.path.basename(p)}"))
        Image.fromarray(img).save(dst)
        print(f"{p} -> {dst}")


def _glow_cfg(a) -> C.GlowConfig:
    run = {k: getattr(a, arg) for k, arg in (
        ("sample_every_iters", "sample_every"),
        ("checkpoint_every_iters", "checkpoint_every"))
        if getattr(a, arg, None) is not None}
    sizes = {k: getattr(a, k) for k in ("n_flows", "n_blocks", "filter_size")
             if getattr(a, k, None) is not None}
    return _with_args(C.GlowConfig(
        fused_coupling=bool(getattr(a, "fused_coupling", False)),
        flow_stack=_flow_stack(getattr(a, "flow_stack", None)), **sizes), a,
        **run)


def _flow_stack(arg):
    """--flow-stack: absent -> False, bare -> True, N -> the int N."""
    return False if arg is None else True if arg == "all" else int(arg)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vgd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("diffusion", help="train DDPM (checkpoints under "
                       "<out-dir>/ckpt, loss log diffusion_loss.jsonl)")
    _add_common(p, serving=False)
    _add_diffusion(p)
    _add_training(p)
    _add_optim(p)

    p = sub.add_parser("vaegan", help="train the VAE-GAN (checkpoints under "
                       "<out-dir>/ckpt, loss log vaegan_loss.jsonl)")
    _add_common(p, serving=False)
    _add_training(p)
    _add_optim(p)
    p.add_argument("--fused-conv", action="store_true",
                   help="encoder/discriminator Conv+BN+LeakyReLU through "
                   "the fused K1 kernel")

    p = sub.add_parser("vae", help="train the denoising VAE (checkpoints "
                       "under <out-dir>/ckpt, loss log vae_loss.jsonl)")
    _add_common(p, serving=False)
    _add_training(p)
    _add_optim(p)
    _add_vae(p)
    p.add_argument("--occlusion", action="store_true",
                   help="train with the occlusion rectangle + per-sample "
                   "noise corruption")
    p.add_argument("--fused-conv", action="store_true",
                   help="encoder Conv+BN+LeakyReLU through the fused K1 "
                   "kernel")

    p = sub.add_parser("eval-vae", help="aggregated-posterior SSIM sweep "
                       "over the checkpoints; with --occlusion the occlusion "
                       "test of one checkpoint instead")
    _add_common(p)
    _add_vae(p)
    p.add_argument("--occlusion", action="store_true",
                   help="occlusion test-set evaluation (test loss, MSE, "
                   "PSNR, SSIM, re-noise cycles, latent traversals)")
    p.add_argument("--max-checkpoints", type=int, default=None)
    p.add_argument("--max-batches", type=int, default=None)

    p = sub.add_parser("denoise", help="encode -> decode restoration of an "
                       "image file or a folder of *.jpg with a VAE "
                       "checkpoint")
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--input", required=True, help="image file or folder")
    p.add_argument("--output", default="denoised.png")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])

    for name in ("gan", "wgan"):
        p = sub.add_parser(name, help=f"train {name.upper()} (checkpoints "
                           f"under <out-dir>/ckpt, loss log gan_loss.jsonl)")
        _add_common(p, serving=False)
        _add_training(p)
        _add_optim(p)
        p.add_argument("--fused-conv", action="store_true",
                       help="discriminator Conv+BN+LeakyReLU through the "
                       "fused K1 kernel")

    p = sub.add_parser("eval-gan", help="prior-sample SSIM sweep over the "
                       "checkpoints")
    _add_common(p)
    p.add_argument("--wgan", action="store_true")
    p.add_argument("--max-checkpoints", type=int, default=None)

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
    _add_optim(p)

    p = sub.add_parser("eval-glow", help="temperature-sample SSIM of a "
                       "Glow checkpoint against the val split")
    _add_common(p)
    _add_glow(p)
    p.add_argument("--max-batches", type=int, default=None)

    p = sub.add_parser("sample", help="sample grid from a checkpoint")
    _add_common(p)
    _add_diffusion(p)
    _add_glow(p)
    _add_vae(p)
    p.add_argument("--family", required=True,
                   choices=["diffusion", "vaegan", "vae", "gan", "wgan",
                            "glow"])
    p.add_argument("-n", "--num-samples", type=int, default=64)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--ddim-steps", type=int, default=0,
                   help=">0 samples through the strided DDIM chain instead "
                   "of the full ancestral chain")
    p.add_argument("--ddim-eta", type=float, default=0.0)

    p = sub.add_parser("eval-diffusion", help="partial-noise restoration "
                       "evaluation (SSIM, PSNR, MSE) of a checkpoint")
    _add_common(p)
    _add_diffusion(p)
    p.add_argument("--max-batches", type=int, default=None)

    a = ap.parse_args(argv)
    from vgd_tpu_torch.train import loop as L

    if a.cmd == "denoise":
        _denoise(a)
        return 0
    if a.cmd == "vae":
        L.run_vae(_vae_cfg(a), max_steps_per_epoch=a.steps_per_epoch,
                  resume=a.resume, device=a.device)
        return 0
    if a.cmd == "eval-vae":
        # --occlusion runs the occlusion test, else the checkpoint sweep
        cfg, res = _vae_cfg(a), {}
        if a.occlusion:
            res["occlusion"] = L.evaluate_vae_occlusion(
                cfg, max_batches=a.max_batches, step=a.step, device=a.device)
        else:
            res["sweep"] = L.evaluate_vae_checkpoints(
                cfg, max_checkpoints=a.max_checkpoints,
                max_eval_batches=a.max_batches, device=a.device)
        print(json.dumps(res))
        return 0
    if a.cmd in ("gan", "wgan"):
        L.run_gan(_gan_cfg(a, a.cmd == "wgan"),
                  max_steps_per_epoch=a.steps_per_epoch, resume=a.resume,
                  device=a.device)
        return 0
    if a.cmd == "eval-gan":
        res = L.evaluate_gan_checkpoints(
            _gan_cfg(a, a.wgan), max_checkpoints=a.max_checkpoints,
            device=a.device)
        print(json.dumps(res))
        return 0
    if a.cmd == "sample" and a.family in ("vae", "gan", "wgan"):
        cfg = _vae_cfg(a) if a.family == "vae" else \
            _gan_cfg(a, a.family == "wgan")
        L.sample_from_dir(a.family, cfg, n=a.num_samples, out_path=a.out,
                          step=a.step, seed=a.seed, device=a.device)
        return 0

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
