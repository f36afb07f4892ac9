"""Command line of the port (``vgd_tpu/cli.py``), DDPM:

  python -m vgd_tpu_torch.cli diffusion --epochs 100 --out-dir runs/diffusion \\
      [--steps-per-epoch 8] [--resume] [--profile-dir runs/diffusion/trace]
  python -m vgd_tpu_torch.cli sample --family diffusion --out-dir runs/diffusion \\
      [-n 16] [--ddim-steps 50 --ddim-eta 0.0]
  python -m vgd_tpu_torch.cli eval-diffusion --out-dir runs/diffusion [--max-batches 1]

``diffusion`` trains (``train.loop.run_diffusion``) and writes
``<out-dir>/ckpt``; ``sample`` and ``eval-diffusion`` restore it. All run on
``--device cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from vgd_tpu_torch.core import config as C


def _add_common(p, serving=True):
    p.add_argument("--out-dir", type=str, default="runs/diffusion")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--dataset-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    if serving:
        p.add_argument("--step", type=int, default=None,
                       help="checkpoint step (default: latest)")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--no-attn", action="store_true")
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])


def _diffusion_cfg(a) -> C.DiffusionConfig:
    cfg = C.DiffusionConfig(timesteps=a.timesteps, attention=not a.no_attn)
    top = {}
    if getattr(a, "epochs", None) is not None:
        top["epochs"] = a.epochs
    if getattr(a, "lr", None) is not None:
        top["lr"] = a.lr
    data = {}
    if a.batch_size is not None:
        data["batch_size"] = a.batch_size
    if a.image_size is not None:
        data["image_size"] = (a.image_size, a.image_size)
    if a.dataset_size is not None:
        data["dataset_size"] = a.dataset_size
    run = {"seed": a.seed, "out_dir": a.out_dir}
    if a.compute_dtype is not None:
        run["compute_dtype"] = a.compute_dtype
    if getattr(a, "profile_dir", None) is not None:
        run["profile_dir"] = a.profile_dir
    if getattr(a, "keep_checkpoints", None) is not None:
        run["keep_checkpoints"] = a.keep_checkpoints
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                               run=dataclasses.replace(cfg.run, **run), **top)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vgd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("diffusion", help="train DDPM (checkpoints under "
                       "<out-dir>/ckpt, loss log diffusion_loss.jsonl)")
    _add_common(p, serving=False)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="truncate epochs (smoke runs)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="torch.profiler trace of train steps 10-20 here")
    p.add_argument("--keep-checkpoints", type=int, default=None)

    p = sub.add_parser("sample", help="sample grid from a checkpoint")
    _add_common(p)
    p.add_argument("--family", required=True, choices=["diffusion"])
    p.add_argument("-n", "--num-samples", type=int, default=64)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--ddim-steps", type=int, default=0,
                   help=">0 samples through the strided DDIM chain instead "
                   "of the full ancestral chain")
    p.add_argument("--ddim-eta", type=float, default=0.0)

    p = sub.add_parser("eval-diffusion", help="partial-noise restoration "
                       "evaluation (PSNR, MSE) of a checkpoint")
    _add_common(p)
    p.add_argument("--max-batches", type=int, default=None)

    a = ap.parse_args(argv)
    from vgd_tpu_torch.train import loop as L

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
