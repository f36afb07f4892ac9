"""Command line of the port (``vgd_tpu/cli.py``), DDPM, VAE-GAN, the
denoising VAE, DCGAN / WGAN, Glow and its EEG variant, and their serving
export:

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
  python -m vgd_tpu_torch.cli glow-eeg --event-type mi|baseline \
      [--iters 6000] [--eeg-path data/bci] [--flows 32 --blocks 4 \
      --filter-size 512] [--resume]
  python -m vgd_tpu_torch.cli eval-eeg --event-type mi [--n-fake 64] [--step N]
  python -m vgd_tpu_torch.cli sample --family glow-eeg --event-type mi [-n 16]
  python -m vgd_tpu_torch.cli tstr --method synt|real|sr|other_sub \
      [--ckpt-dir runs/glow_eeg] [--subjects 01 02] [--n-samples 288]
  python -m vgd_tpu_torch.cli eval-gan|eval-vae|eval-glow|eval-diffusion \
      --fid [--inception-weights pt_inception.pth]
  python -m vgd_tpu_torch.cli export --family diffusion --out-dir runs/ddpm \
      [-n 16] [--ddim-steps 50] [--mode denoise --poly-batch] \
      [--platforms cuda,cpu] [--artifact serving.pt2]
  python -m vgd_tpu_torch.cli infer --artifact serving.pt2 [--seed 0] \
      [--out grid.jpg] [--input x.npy|img.jpg] [--device cpu]

``diffusion``, ``vaegan``, ``vae``, ``gan``, ``wgan`` and ``glow`` train
(``train.loop.run_diffusion`` / ``run_vaegan`` / ``run_vae`` / ``run_gan``
/ ``run_glow``) and write ``<out-dir>/ckpt``; ``sample``, the ``eval-*``
commands and ``denoise`` restore it. ``glow-eeg`` trains one event type's
EEG flow (``run_glow_eeg``) into ``<out-dir>/ckpt_<event-type>``;
``eval-eeg`` compares its samples' PSD with the real trials', and ``tstr``
trains CSP + LDA on generated (``synt``), real, both (``sr``) or another
subject's trials and tests on the real E session. ``--fid`` adds FID and
manifold precision / recall (and IS with ``--inception-weights``, a torch
InceptionV3 state_dict; without it the seeded surrogate's keys end in
``_surrogate``) to ``vaegan``'s validation and the ``eval-*`` commands.
``wgan`` trains 1500 epochs unless ``--epochs`` says otherwise (the
reference's scale). ``denoise`` reads an image file or every ``*.jpg`` of
a folder with PIL (imported there only) and writes the restorations as
images. ``export`` traces a checkpoint's serving program into one ``.pt2``
(``io/export.py``: the sampler, one diffusion step, or the denoiser, with
the kernels as registered ops) and ``infer`` runs it with no model code.
``--data`` names a folder of ``*.jpg`` (decoded once into a uint8 memmap
cache; synthetic faces without it); ``--debug-nans`` trains under
autograd's anomaly detection. All run on ``--device cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from vgd_tpu_torch.core import config as C


def _add_common(p, serving=True):
    p.add_argument("--data", type=str, default=None,
                   help="folder of *.jpg, decoded once into a uint8 memmap "
                   "cache beside them (default, or not a folder: synthetic "
                   "faces)")
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


def _add_fid(p):
    p.add_argument("--fid", action="store_true",
                   help="FID, IS and manifold precision / recall on "
                   "InceptionV3 features (per epoch for vaegan)")
    p.add_argument("--inception-weights", type=str, default=None,
                   help="torch InceptionV3 state_dict (pytorch-fid "
                   "pt_inception) for real FID / IS (implies --fid); "
                   "without it a seeded surrogate, keys tagged _surrogate")


def _feature_fn(a):
    from vgd_tpu_torch.train import loop as L
    return L.load_feature_fn(a.fid, a.inception_weights, device=a.device)[0]


def _add_eeg(p, sizes=True):
    p.add_argument("--event-type", default="mi", choices=["mi", "baseline"])
    p.add_argument("--eeg-path", type=str, default=None,
                   help="folder of BCI-IV-2a *.npz (default: synthetic "
                   "trials)")
    if sizes:
        p.add_argument("--flows", dest="n_flows", type=int, default=None,
                       help="K (32)")
        p.add_argument("--blocks", dest="n_blocks", type=int, default=None,
                       help="L (4)")
        p.add_argument("--filter-size", type=int, default=None,
                       help="coupling width (512)")


# RunConfig fields a command line may set (a flag left out leaves the
# config's value)
_RUN_ARGS = ("out_dir", "compute_dtype", "profile_dir", "keep_checkpoints",
             "debug_nans")


def _eeg_cfg(a) -> C.GlowEEGConfig:
    """``GlowEEGConfig`` with the values given on the command line."""
    top = {k: getattr(a, k) for k in (
        "n_flows", "n_blocks", "filter_size", "batch_size", "lr")
        if getattr(a, k, None) is not None}
    run = {"seed": a.seed}
    for k in _RUN_ARGS:
        if getattr(a, k, None) is not None:
            run[k] = getattr(a, k)
    cfg = C.GlowEEGConfig(event_type=a.event_type, eeg_path=a.eeg_path)
    return dataclasses.replace(cfg, run=dataclasses.replace(cfg.run, **run),
                               **top)


def _tstr(a) -> None:
    """The TSTR protocol: for each subject, CSP + LDA trained on the chosen
    regime's trials and tested on the real E session (motor imagery 1,
    baseline 0)."""
    import numpy as np
    from vgd_tpu_torch.data.eeg import EEGDataset
    from vgd_tpu_torch.eval.eeg_downstream import tstr_evaluate
    from vgd_tpu_torch.io.checkpoint import has_checkpoint

    if a.method in ("synt", "sr"):
        # stop before any work when a per-class flow is missing
        missing = [f"{a.ckpt_dir}/ckpt_{e}" for e in ("mi", "baseline")
                   if not has_checkpoint(f"{a.ckpt_dir}/ckpt_{e}")]
        if missing:
            raise SystemExit(
                f"tstr --method {a.method} samples trained per-class EEG "
                f"flows, but no checkpoint exists under: "
                f"{', '.join(missing)}.\nTrain them first:\n"
                f"  python -m vgd_tpu_torch.cli glow-eeg --iters 6000 "
                f"--event-type mi --out-dir {a.ckpt_dir}\n"
                f"  python -m vgd_tpu_torch.cli glow-eeg --iters 6000 "
                f"--event-type baseline --out-dir {a.ckpt_dir}")
    # the flows' samples are the same for every subject: drawn once
    generated = generate_synthetic_eeg(a) if a.method in ("synt", "sr") \
        else None
    results = {}
    for i, subject in enumerate(a.subjects):
        te_mi = EEGDataset(a.eeg_path, "E", "mi", subject).as_ncT()
        te_bl = EEGDataset(a.eeg_path, "E", "baseline", subject).as_ncT()
        X_test = np.concatenate([te_mi, te_bl]).astype(np.float64)
        y_test = np.concatenate([np.ones(len(te_mi)), np.zeros(len(te_bl))])
        X_parts, y_parts = [], []
        if generated is not None:
            X_mi, X_bl = generated
            X_parts += [X_mi, X_bl]
            y_parts += [np.ones(len(X_mi)), np.zeros(len(X_bl))]
        if a.method in ("real", "sr", "other_sub"):
            src = a.subjects[i - 1] if a.method == "other_sub" else subject
            tr_mi = EEGDataset(a.eeg_path, "T", "mi", src).as_ncT()
            tr_bl = EEGDataset(a.eeg_path, "T", "baseline", src).as_ncT()
            X_parts += [tr_mi, tr_bl]
            y_parts += [np.ones(len(tr_mi)), np.zeros(len(tr_bl))]
        train_scores, test_scores = tstr_evaluate(
            np.concatenate(X_parts).astype(np.float64),
            np.concatenate(y_parts), X_test, y_test)
        results[subject] = {"train": train_scores, "test": test_scores}
        print(f"subject {subject} method {a.method}: "
              f"train {train_scores} | test {test_scores}")
    print(json.dumps(results))


def generate_synthetic_eeg(a):
    """(motor imagery, baseline) trials (N, C, T) sampled at temperature
    0.7 from the per-class flows under ``a.ckpt_dir`` (z drawn from seed
    42), ``a.n_samples`` each; non-finite trials are dropped, and a class
    with none left raises."""
    import numpy as np
    from vgd_tpu_torch.train import loop as L

    sizes = {k: getattr(a, k) for k in ("n_flows", "n_blocks", "filter_size")
             if getattr(a, k) is not None}
    out = []
    for etype in ("mi", "baseline"):
        cfg = C.GlowEEGConfig(
            event_type=etype, run=dataclasses.replace(
                C.GlowEEGConfig().run, out_dir=a.ckpt_dir), **sizes)
        trainer = L.restore_glow_eeg(cfg, device=a.device)
        arr = L.sample_eeg(trainer, a.n_samples, seed=42)
        finite = np.isfinite(arr).all(axis=(1, 2))
        if not finite.all():
            print(f"warning: dropping {int((~finite).sum())}/{len(arr)} "
                  f"non-finite generated '{etype}' trials (an undertrained "
                  f"flow's reverse can overflow)")
            arr = arr[finite]
        if len(arr) == 0:
            raise RuntimeError(
                f"all generated '{etype}' trials are non-finite: train the "
                f"flow longer before TSTR (the reference trains 6000 "
                f"iterations)")
        out.append(arr)
    return out[0], out[1]


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
    the reference takes both) and --debug-nans."""
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default: the config's)")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="checkpoint retention count (default 3)")
    p.add_argument("--debug-nans", action="store_true",
                   help="train under autograd anomaly detection: a "
                   "backward that makes a NaN raises, naming its op")


def _with_args(cfg, a, **run):
    """``cfg`` with the values given on the command line."""
    data = {k: getattr(a, k) for k in ("batch_size", "dataset_size")
            if getattr(a, k) is not None}
    if a.image_size is not None:
        data["image_size"] = (a.image_size, a.image_size)
    if getattr(a, "data", None) is not None:
        data["path"] = a.data
    run["seed"] = a.seed
    for k in _RUN_ARGS:
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


def _add_family(p):
    """``sample`` and ``export``: the family and its model flags."""
    _add_common(p)
    _add_diffusion(p)
    _add_glow(p)
    _add_vae(p)
    _add_eeg(p, sizes=False)
    p.add_argument("--family", required=True,
                   choices=["diffusion", "vaegan", "vae", "gan", "wgan",
                            "glow", "glow-eeg"])
    p.add_argument("-n", "--num-samples", type=int, default=64)
    p.add_argument("--ddim-steps", type=int, default=0,
                   help=">0 samples through the strided DDIM chain instead "
                   "of the full ancestral chain")
    p.add_argument("--ddim-eta", type=float, default=0.0)


def _family_cfg(a):
    """The config of ``a.family`` with the values given on the command
    line."""
    if a.family == "glow-eeg":
        cfg = _eeg_cfg(a)
    elif a.family == "vae":
        cfg = _vae_cfg(a)
    elif a.family in ("gan", "wgan"):
        cfg = _gan_cfg(a, a.family == "wgan")
    elif a.family == "glow":
        cfg = _glow_cfg(a)
    elif a.family == "vaegan":
        cfg = _vaegan_cfg(a)
    else:
        cfg = _diffusion_cfg(a)
    if getattr(a, "temperature", None) is not None:
        if a.family not in ("glow", "glow-eeg"):
            raise SystemExit("--temperature applies to glow and glow-eeg")
        cfg = dataclasses.replace(cfg, temperature=a.temperature)
    return cfg


def _infer(a) -> None:
    """One serving call on an ``export`` artifact: no model code, config or
    checkpoint is read, only the program. A static-batch denoise artifact
    takes the request padded (by repetition) or cut to its n."""
    import os

    import numpy as np
    from vgd_tpu_torch.io.export import load_artifact, run_artifact

    call, meta = load_artifact(a.artifact, device=a.device)
    inputs = None
    if meta.get("mode") == "denoise":
        if not a.input:
            raise SystemExit("denoise artifact needs --input "
                             "(.npy batch or image file)")
        if a.input.endswith(".npy"):
            inputs = np.load(a.input).astype(np.float32)
            if inputs.ndim == 3:                 # a single (H, W, C) image
                inputs = inputs[None]
            if inputs.ndim != 4:
                raise SystemExit(f"--input {a.input}: expected [H,W,C] or "
                                 f"[N,H,W,C], got shape {inputs.shape}")
        else:
            from PIL import Image
            h, w = meta["inputs"][0][1][1:3]
            img = Image.open(a.input).convert("RGB").resize((w, h))
            inputs = np.asarray(img, np.float32)[None] / 127.5 - 1.0
        if not meta.get("poly_batch"):
            n = int(meta["n"])
            if inputs.shape[0] > n:
                print(f"[infer] warning: --input batch {inputs.shape[0]} > "
                      f"exported n={n}; only the first {n} rows are "
                      f"processed (re-export with --poly-batch to serve "
                      f"any batch size)")
            reps = -(-n // inputs.shape[0])      # pad by repetition to n
            inputs = np.tile(inputs, (reps, 1, 1, 1))[:n]
    out = run_artifact(seed=a.seed, inputs=inputs, loaded=(call, meta))
    base = a.out or a.artifact.rsplit(".", 1)[0]
    if meta.get("family") == "glow-eeg":
        from vgd_tpu_torch.data.eeg import CHANNEL_NAMES
        from vgd_tpu_torch.utils.viz import have_matplotlib, plot_eeg_signals
        stem = os.path.splitext(base)[0]
        dst = stem + ".npz"
        np.savez(dst, signals=out)
        if have_matplotlib():
            plot_eeg_signals(out[:, :, 0, :].transpose(0, 2, 1),
                             stem + ".png", channel_names=CHANNEL_NAMES)
    else:
        from vgd_tpu_torch.io.artifacts import save_grid
        dst = base if base.endswith((".jpg", ".png")) else base + ".jpg"
        save_grid(out, dst)
    print(f"[infer] {a.artifact} (mode={meta.get('mode', 'sample')}, "
          f"{meta['device']}) -> {dst}  out shape {out.shape}")


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
    _add_fid(p)

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
                       "test of one checkpoint instead (with --fid both)")
    _add_common(p)
    _add_vae(p)
    _add_fid(p)
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
    _add_fid(p)
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
    _add_fid(p)
    p.add_argument("--max-batches", type=int, default=None)

    p = sub.add_parser("sample", help="sample grid from a checkpoint")
    _add_family(p)
    p.add_argument("--out", type=str, default=None)

    p = sub.add_parser("export", help="serving export: trace a trained "
                       "checkpoint's inference program (sampler, one "
                       "diffusion step, or denoiser) with torch.export into "
                       "one .pt2, parameters in it, for cuda and cpu "
                       "(io/export.py; run it with `infer`)")
    _add_family(p)
    p.add_argument("--mode", default="sample", choices=["sample", "denoise"],
                   help="sample: draws -> image batch; denoise: (images, "
                   "draw) -> reconstructions (vae / vaegan)")
    p.add_argument("--temperature", type=float, default=None,
                   help="glow / glow-eeg: z temperature (default: the "
                   "config's)")
    p.add_argument("--platforms", type=str, default="cuda,cpu",
                   help="comma-separated devices the artifact may be "
                   "loaded on")
    p.add_argument("--artifact", type=str, default=None,
                   help="output path (default "
                   "<out-dir>/serving_<family>_<mode>.pt2)")
    p.add_argument("--poly-batch", action="store_true",
                   help="denoise exports: a symbolic batch dimension, so one "
                   "artifact serves any request batch size")

    p = sub.add_parser("infer", help="load an `export` artifact and run one "
                       "serving call (no model code, config or checkpoint)")
    p.add_argument("--artifact", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None,
                   help="output grid .jpg / .png (glow-eeg: .npz, and a "
                   "trace .png where matplotlib imports); default next to "
                   "the artifact")
    p.add_argument("--input", type=str, default=None,
                   help="denoise artifacts: .npy batch or image file")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])

    p = sub.add_parser("eval-diffusion", help="partial-noise restoration "
                       "evaluation (SSIM, PSNR, MSE) of a checkpoint")
    _add_common(p)
    _add_diffusion(p)
    _add_fid(p)
    p.add_argument("--max-batches", type=int, default=None)

    p = sub.add_parser("glow-eeg", help="train one event type's EEG Glow "
                       "(checkpoints under <out-dir>/ckpt_<event-type>, "
                       "loss log eeg_<event-type>.jsonl)")
    _add_common(p, serving=False)
    _add_eeg(p)
    p.add_argument("--iters", type=int, default=None,
                   help="iterations (default: the config's 6000)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="torch.profiler trace of train steps 10-20 here")
    _add_optim(p)

    p = sub.add_parser("eval-eeg", help="real-vs-generated central PSD "
                       "(psd_<event-type>.npz; figure and training GIF "
                       "where matplotlib is installed)")
    _add_common(p)
    _add_eeg(p)
    p.add_argument("--n-fake", type=int, default=64)

    p = sub.add_parser("tstr", help="EEG downstream evaluation: CSP + LDA "
                       "trained on generated / real trials, tested on the "
                       "real E session")
    _add_eeg(p)
    p.add_argument("--method", default="synt",
                   choices=["synt", "real", "sr", "other_sub"])
    p.add_argument("--ckpt-dir", type=str, default="runs/glow_eeg",
                   help="the glow-eeg --out-dir holding ckpt_mi and "
                   "ckpt_baseline")
    p.add_argument("--subjects", nargs="*", default=["01"])
    p.add_argument("--n-samples", type=int, default=288,
                   help="generated trials per class (synt, sr)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])

    a = ap.parse_args(argv)
    from vgd_tpu_torch.train import loop as L

    if a.cmd == "tstr":
        _tstr(a)
        return 0
    if a.cmd == "glow-eeg":
        L.run_glow_eeg(_eeg_cfg(a), n_iter=a.iters, resume=a.resume,
                       device=a.device)
        return 0
    if a.cmd == "eval-eeg":
        print(json.dumps(L.eeg_psd_and_gif(_eeg_cfg(a), n_fake=a.n_fake,
                                           step=a.step, device=a.device)))
        return 0
    if a.cmd == "sample":
        L.sample_from_dir(a.family, _family_cfg(a), n=a.num_samples,
                          out_path=a.out, step=a.step, seed=a.seed,
                          ddim_steps=a.ddim_steps, ddim_eta=a.ddim_eta,
                          device=a.device)
        return 0
    if a.cmd == "export":
        from vgd_tpu_torch.io.export import export_serving
        export_serving(a.family, _family_cfg(a), n=a.num_samples,
                       mode=a.mode, step=a.step, ddim_steps=a.ddim_steps,
                       ddim_eta=a.ddim_eta,
                       platforms=tuple(a.platforms.split(",")),
                       artifact_path=a.artifact, poly_batch=a.poly_batch)
        return 0
    if a.cmd == "infer":
        _infer(a)
        return 0
    if a.cmd == "denoise":
        _denoise(a)
        return 0
    if a.cmd == "vae":
        L.run_vae(_vae_cfg(a), max_steps_per_epoch=a.steps_per_epoch,
                  resume=a.resume, device=a.device)
        return 0
    if a.cmd == "eval-vae":
        # --occlusion runs the occlusion test, alone or, with --fid, beside
        # the checkpoint sweep; no flag runs the sweep
        cfg, res = _vae_cfg(a), {}
        if a.occlusion:
            res["occlusion"] = L.evaluate_vae_occlusion(
                cfg, max_batches=a.max_batches, step=a.step, device=a.device)
        if a.fid or a.inception_weights or not a.occlusion:
            res["sweep"] = L.evaluate_vae_checkpoints(
                cfg, feature_fn=_feature_fn(a),
                max_checkpoints=a.max_checkpoints,
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
            _gan_cfg(a, a.wgan), feature_fn=_feature_fn(a),
            max_checkpoints=a.max_checkpoints, device=a.device)
        print(json.dumps(res))
        return 0

    if a.cmd == "glow":
        L.run_glow(_glow_cfg(a), n_iter=a.iters, resume=a.resume,
                   device=a.device)
        return 0
    if a.cmd == "eval-glow":
        res = L.evaluate_glow_from_dir(
            _glow_cfg(a), feature_fn=_feature_fn(a),
            max_batches=a.max_batches, step=a.step, device=a.device)
        print(json.dumps(res))
        return 0
    if a.cmd == "vaegan":
        L.run_vaegan(_vaegan_cfg(a), max_steps_per_epoch=a.steps_per_epoch,
                     feature_fn=_feature_fn(a), resume=a.resume,
                     device=a.device)
        return 0
    cfg = _diffusion_cfg(a)
    if a.cmd == "diffusion":
        L.run_diffusion(cfg, max_steps_per_epoch=a.steps_per_epoch,
                        resume=a.resume, device=a.device)
    else:
        res = L.evaluate_diffusion_from_dir(cfg, feature_fn=_feature_fn(a),
                                            max_batches=a.max_batches,
                                            step=a.step, device=a.device)
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
