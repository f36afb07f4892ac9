"""Entry points of the port (``vgd_tpu/train/loop.py``): DDPM training
(``run_diffusion``), VAE-GAN training (``run_vaegan``), denoising-VAE
training (``run_vae``) with its aggregated-posterior checkpoint sweep
(``evaluate_vae_checkpoints``), occlusion test (``evaluate_vae_occlusion``)
and image restoration (``denoise_images``), DCGAN / WGAN training
(``run_gan``) and its checkpoint sweep (``evaluate_gan_checkpoints``), Glow
training (``run_glow``) and its temperature-sampled evaluation
(``evaluate_glow``), EEG Glow training per event type (``run_glow_eeg``)
with its PSD comparison (``eeg_psd_and_gif``), sample grids from a
checkpoint of any of them and partial-noise restoration evaluation. Every
evaluation takes an Inception ``feature_fn`` (``load_feature_fn``) for FID,
IS and manifold precision / recall beside SSIM.

Grids and panels are written as ``.npy`` arrays in [-1, 1] with a picture
beside them where PIL imports, and each epoch's loss curves where
matplotlib imports (``io/artifacts.py``); EEG samples as ``.npz`` /
``.npy`` arrays (N, C, T), with trace plots and the PSD figure drawn only
where matplotlib is installed. ``RunConfig.debug_nans`` runs a training
loop under autograd's anomaly detection. The JAX loop's mesh,
sequence-parallel and epoch-scan options have no counterpart here: the
port runs one device and loops over steps in Python.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from vgd_tpu_torch.core.config import (DiffusionConfig, GANConfig,
                                       GlowConfig, GlowEEGConfig, VAEConfig,
                                       VAEGANConfig, to_dict)
from vgd_tpu_torch.core.rng import resolve_device, seed_all
from vgd_tpu_torch.data.celeba import make_image_datasets
from vgd_tpu_torch.data.corrupt import corrupt, corrupt_draws
from vgd_tpu_torch.data.eeg import CHANNEL_NAMES, EEGDataset, eeg_batches
from vgd_tpu_torch.eval.eeg_downstream import mean_central_psd
from vgd_tpu_torch.eval.metrics import (MetricAccumulator, mse_metric, psnr,
                                        ssim)
from vgd_tpu_torch.eval.sampling import aggregated_posterior_sampler
from vgd_tpu_torch.eval.vae_analysis import (denoise_test_loss,
                                             latent_traversal, renoise_cycle)
from vgd_tpu_torch.io.artifacts import (MetricLog, epoch_metrics, save_grid,
                                        save_triplets)
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.models.vae import reparameterize
from vgd_tpu_torch.ops.image import signed_to_unit, to_signed
from vgd_tpu_torch.train.diffusion import (DiffusionState, DiffusionTrainer,
                                           q_sample)
from vgd_tpu_torch.train.gan import GANTrainer
from vgd_tpu_torch.train.glow import GlowEEGTrainer, GlowTrainer
from vgd_tpu_torch.train.vae import VAETrainer
from vgd_tpu_torch.train.vaegan import VAEGANTrainer
from vgd_tpu_torch.utils.prefetch import device_prefetch
from vgd_tpu_torch.utils.viz import have_matplotlib, plot_eeg_signals, \
    save_gif

# offset of the validation generator's seed from the run seed: every epoch
# scores the same t and noise draws, as the JAX loop folds a fixed
# 30_000 + j into its key for val batch j
VAL_SEED_OFFSET = 30_000
# the VAE-GAN loop's fixed grid latents and validation draws, likewise from
# fixed offsets (the JAX loop folds 7 and 10_000 + j into its key)
FIXED_Z_SEED_OFFSET = 7
VAEGAN_VAL_SEED_OFFSET = 10_000
# the VAE loop's validation draws (the JAX loop folds 20_000 + j)
VAE_VAL_SEED_OFFSET = 20_000
# the EEG PSD comparison's temperature z (the JAX function folds 3)
EEG_PSD_SEED_OFFSET = 3


def _debug_nans(run):
    """Runs ``run(cfg, ...)`` under ``torch.autograd.set_detect_anomaly``
    when ``cfg.run.debug_nans`` is set (the counterpart of the JAX loop's
    ``jax_debug_nans``: a backward that makes a NaN raises, naming the
    forward op that made it)."""
    @functools.wraps(run)
    def wrapped(cfg, *args, **kwargs):
        if not cfg.run.debug_nans:
            return run(cfg, *args, **kwargs)
        with torch.autograd.set_detect_anomaly(True):
            return run(cfg, *args, **kwargs)
    return wrapped


class _Profiler:
    """``torch.profiler`` trace of global train steps [start, stop) written
    as a Chrome trace into ``RunConfig.profile_dir`` (no-op when unset)."""

    def __init__(self, run_cfg, device: torch.device):
        self.dir = run_cfg.profile_dir
        self.start_step, self.stop_step = run_cfg.profile_steps
        self.device = device
        self.prof = None

    def step(self, i: int) -> None:
        if not self.dir:
            return
        if i == self.start_step and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        elif i == self.stop_step:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.dir, f"trace_steps_{self.start_step}_{self.stop_step}.json"))
        self.prof = None


def _image_shape(cfg):
    return tuple(cfg.data.image_size) + (cfg.data.channels,)


def restore_trainer(cfg: DiffusionConfig, step: Optional[int] = None,
                    device="cuda") -> DiffusionTrainer:
    """A trainer on ``device`` with the latest (or given) checkpoint of
    ``<out_dir>/ckpt`` loaded."""
    trainer = DiffusionTrainer(cfg, _image_shape(cfg), device=device)
    params, s, _ = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt")).restore(
        step, map_location=trainer.device)
    trainer.load(DiffusionState(params=params))
    print(f"[checkpoint] restored step {s}")
    return trainer


def save_checkpoint(cfg: DiffusionConfig, trainer: DiffusionTrainer,
                    step: int) -> str:
    """Write the trainer's parameters as ``<out_dir>/ckpt`` step ``step``."""
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    return ckpt.save(step, trainer.model.state_dict(), to_dict(cfg))


@_debug_nans
def run_diffusion(cfg: DiffusionConfig, epochs: Optional[int] = None,
                  max_steps_per_epoch: Optional[int] = None,
                  resume: bool = False, device="cuda") -> Dict:
    """Train DDPM: per epoch, train steps over ``device_prefetch``ed
    batches (the loss summed on the device and read once), the validation
    epsilon-MSE over the true rows of every val batch, a ``MetricLog`` row
    (train_loss, val_loss, images_per_sec) and, every
    ``checkpoint_every_epochs``, a checkpoint of params, Adam state and the
    generator state at step = epochs done. ``resume`` continues from the
    latest checkpoint exactly: same parameters, moments, draws and batch
    order as a run that never stopped."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = DiffusionTrainer(cfg, img_shape, device=device)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(DiffusionState(params=payload["params"],
                                    opt_state=payload["opt_state"],
                                    step=payload["opt_step"]))
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    log = MetricLog(cfg.run.out_dir, "diffusion_loss")
    prof = _Profiler(cfg.run, device)
    epochs = cfg.epochs if epochs is None else epochs
    gstep, n_val = trainer.step, 0
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        total_dev, count = None, 0
        batches = device_prefetch((b for b, _ in train.epoch()), size=2,
                                  device=device)
        for i, batch in enumerate(batches):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            prof.step(gstep)
            loss = trainer.train_step(batch, gen)
            gstep += 1
            count += 1
            total_dev = loss if total_dev is None else total_dev + loss
        total = float(total_dev) if count else 0.0
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)
        vgen = torch.Generator(device=device).manual_seed(
            cfg.run.seed + VAL_SEED_OFFSET)
        val_dev, n_val = torch.zeros((), device=device), 0
        for vbatch, n_valid in val.epoch():
            vl = trainer.eval_loss(torch.from_numpy(vbatch), vgen)
            # the padded repeats of a final batch must not count
            val_dev = val_dev + vl[:n_valid].sum()
            n_val += n_valid
        train_loss = total / max(count, 1)
        val_loss = float(val_dev) / max(n_val, 1)
        log.append(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                   images_per_sec=ips)
        print(f"[diffusion] epoch {epoch + 1}/{epochs} train={train_loss:.4f}"
              f" val={val_loss:.4f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            ckpt.save(epoch + 1, trainer.model.state_dict(), to_dict(cfg),
                      opt_state=trainer.opt.state_dict(),
                      rng_state=gen.get_state(), opt_step=trainer.step)
        epoch_metrics(log, "diffusion_")
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def evaluate_diffusion(cfg: DiffusionConfig, trainer: DiffusionTrainer, val,
                       feature_fn=None, max_batches: Optional[int] = None,
                       save_panels: bool = True) -> Dict[str, float]:
    """Restoration evaluation: noise each val batch to a seeded random
    start step, run the ancestral chain back, and score on [0, 1] images
    over the true rows (padded repeats of the last batch excluded): SSIM
    (and, with ``feature_fn``, FID / IS / P-R) through
    ``MetricAccumulator`` and PSNR, as the reference returns them, and MSE
    beside them. With
    ``save_panels`` the first batch's original / noisy / multi-step /
    one-step panel is saved as ``diffusion_restore_panel.npy``."""
    gen = seed_all(cfg.run.seed, trainer.device)
    dev = trainer.device
    acc = MetricAccumulator(feature_fn=feature_fn)
    psnr_sum, mse_sum, n_b = 0.0, 0.0, 0
    for j, (vbatch, n_valid) in enumerate(val.epoch()):
        if max_batches is not None and j >= max_batches:
            break
        x0 = to_signed(torch.from_numpy(vbatch).to(dev))
        # batch-wide random start step, as the reference takes ts[0]
        t_start = int(torch.randint(0, cfg.timesteps, (), generator=gen,
                                    device=dev))
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        t_vec = torch.full((x0.shape[0],), t_start, dtype=torch.int32,
                           device=dev)
        xt = q_sample(trainer.sched, x0, t_vec, noise)
        restored = trainer.ancestral_sample(xt, t_start, generator=gen)
        fake_unit = signed_to_unit(restored)[:n_valid]
        real_unit = signed_to_unit(x0)[:n_valid]
        acc.update(fake_unit, real_unit)
        psnr_sum += float(psnr(fake_unit, real_unit)) * n_valid
        mse_sum += float(mse_metric(fake_unit, real_unit)) * n_valid
        n_b += n_valid
        if save_panels and j == 0:
            one_step = trainer.predict_x0(xt, t_vec)
            n_show = min(4, x0.shape[0])
            panel = torch.stack([x0, torch.clamp(xt, -1, 1), restored,
                                 one_step])[:, :n_show]
            os.makedirs(cfg.run.out_dir, exist_ok=True)
            np.save(os.path.join(cfg.run.out_dir,
                                 "diffusion_restore_panel.npy"),
                    panel.float().cpu().numpy())
    out = acc.compute()
    out.update(psnr=psnr_sum / max(n_b, 1), mse=mse_sum / max(n_b, 1))
    return out


def evaluate_diffusion_from_dir(cfg: DiffusionConfig, feature_fn=None,
                                max_batches: Optional[int] = None,
                                step: Optional[int] = None,
                                device="cuda") -> Dict[str, float]:
    """Restore the latest (or given) DDPM checkpoint and run the
    restoration evaluation on the val split."""
    device = resolve_device(device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_trainer(cfg, step, device)
    out = evaluate_diffusion(cfg, trainer, val, feature_fn=feature_fn,
                             max_batches=max_batches)
    np.savez(os.path.join(cfg.run.out_dir, "diffusion_eval_metrics.npz"),
             **out)
    print("[eval-diffusion] " +
          " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def _restored(trainer, directory: str, step: Optional[int] = None):
    """``trainer`` with the latest (or given) checkpoint under
    ``directory`` loaded (weights and buffers)."""
    params, s, _ = Checkpointer(directory).restore(
        step, map_location=trainer.device)
    trainer.load(params)
    print(f"[checkpoint] restored step {s}")
    return trainer


def restore_vaegan(cfg: VAEGANConfig, step: Optional[int] = None,
                   device="cuda") -> VAEGANTrainer:
    """A VAE-GAN trainer on ``device`` with the latest (or given) checkpoint
    of ``<out_dir>/ckpt`` loaded (weights and BN running stats)."""
    return _restored(VAEGANTrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


@_debug_nans
def run_vaegan(cfg: VAEGANConfig, epochs: Optional[int] = None,
               max_steps_per_epoch: Optional[int] = None,
               feature_fn=None, resume: bool = False, device="cuda") -> Dict:
    """Train the VAE-GAN: per epoch, ``train_step`` over
    ``device_prefetch``ed batches with the KL ramp of the epoch (the losses
    summed on the device and read once: epoch metrics are means over every
    step), then the denoising validation pass over the true rows of every
    val batch (val loss = mean(per_mse[:n]) + alpha_kl * sum(per_kl[:n]),
    weighted by n; PSNR; SSIM, and with ``feature_fn`` FID / IS / P-R,
    through ``MetricAccumulator``), a
    ``MetricLog`` row, the noisy / clean / reconstruction panel and the
    fixed-z sample grid (``.npy``), and every ``checkpoint_every_epochs`` a
    checkpoint of the three networks (BN buffers included), the three Adam
    states, the optimizer step and the generator state at step = epochs
    done. ``resume`` continues from the latest checkpoint exactly."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = VAEGANTrainer(cfg, img_shape, device=device)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    log = MetricLog(cfg.run.out_dir, "vaegan_loss")
    prof = _Profiler(cfg.run, device)
    fixed_z = torch.randn(
        (64, cfg.latent_dim), device=device, generator=torch.Generator(
            device=device).manual_seed(cfg.run.seed + FIXED_Z_SEED_OFFSET))
    epochs = cfg.epochs if epochs is None else epochs
    gstep, n_val = trainer.step, 0
    od = cfg.run.out_dir
    for epoch in range(start_epoch, epochs):
        ramp = trainer.kl_ramp(epoch)
        t0 = time.perf_counter()
        sums, count = {}, 0
        batches = device_prefetch((b for b, _ in train.epoch()), size=2,
                                  device=device)
        for i, batch in enumerate(batches):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            prof.step(gstep)
            m = trainer.train_step(batch, ramp, gen)
            gstep += 1
            count += 1
            sums = {k: v + sums[k] if k in sums else v for k, v in m.items()}
        means = {f"train_{k}": float(v) / count for k, v in sums.items()}
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)

        tv0 = time.perf_counter()
        acc = MetricAccumulator(feature_fn=feature_fn)
        vgen = torch.Generator(device=device).manual_seed(
            cfg.run.seed + VAEGAN_VAL_SEED_OFFSET)
        rows, ns, panel = [], [], None
        for vbatch, n in val.epoch():
            vb = torch.from_numpy(vbatch).to(device)
            ev = trainer.eval_step(vb, vgen)
            img = to_signed(vb)
            recon_u, img_u = signed_to_unit(ev["recon"]), signed_to_unit(img)
            # only the true rows of a padded final batch count
            acc.update(recon_u, img_u, n_valid=n)
            rows.append(torch.stack([ev["per_mse"][:n].mean(),
                                     ev["per_kl"][:n].sum(),
                                     psnr(recon_u[:n], img_u[:n])]))
            ns.append(n)
            if panel is None:
                panel = (ev["noisy"], img, ev["recon"])
        n_val = sum(ns)
        vals = torch.stack(rows).double().cpu().tolist() if rows else []
        val_loss = sum((mse_ + cfg.alpha_kl * kl_) * n
                       for (mse_, kl_, _), n in zip(vals, ns))
        metrics = acc.compute()
        metrics["psnr"] = sum(p * n for (_, _, p), n in zip(vals, ns)) \
            / max(n_val, 1)
        row = dict(means, val_loss=val_loss / max(n_val, 1),
                   images_per_sec=ips, val_secs=time.perf_counter() - tv0,
                   **metrics)
        log.append(epoch=epoch, **row)
        print(f"[vaegan] epoch {epoch + 1}/{epochs} "
              f"recon={row.get('train_recon', 0):.4f} "
              f"val={row['val_loss']:.4f} ssim={metrics['ssim']:.4f} "
              f"psnr={metrics['psnr']:.2f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            ckpt.save(epoch + 1, trainer.state_dict(), to_dict(cfg),
                      opt_state=trainer.opt_state(),
                      rng_state=gen.get_state(), opt_step=trainer.step)
        if panel is not None:     # the val split can be empty on tiny data
            save_triplets(*panel, os.path.join(
                od, f"vaegan_decode_epoch_{epoch + 1:04d}.npy"))
        save_grid(trainer.generate(fixed_z), os.path.join(
            od, f"vaegan_fake_epoch_{epoch + 1:04d}.npy"))
        epoch_metrics(log)
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def restore_vae(cfg: VAEConfig, step: Optional[int] = None,
                device="cuda") -> VAETrainer:
    """A VAE trainer on ``device`` with the latest (or given) checkpoint of
    ``<out_dir>/ckpt`` loaded (weights and BN running stats)."""
    return _restored(VAETrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


@_debug_nans
def run_vae(cfg: VAEConfig, epochs: Optional[int] = None,
            max_steps_per_epoch: Optional[int] = None, resume: bool = False,
            device="cuda") -> Dict:
    """Train the denoising VAE: per epoch, ``train_step`` over
    ``device_prefetch``ed batches with the KL ramp of the epoch (the loss
    summed on the device and read once), then the random-std denoising
    validation over the true rows of every val batch (val loss = mean(
    per_mse[:n]) + sum(per_kl[:n]), weighted by n; MSE, PSNR and SSIM of
    the [0, 1] reconstructions, each weighted by n), a ``MetricLog`` row,
    the noisy / clean / reconstruction panel and the fixed-z grid
    (``.npy``), and every ``checkpoint_every_epochs`` a checkpoint of both
    networks (BN buffers included), the Adam state, the optimizer step and
    the generator state at step = epochs done. ``resume`` continues from
    the latest checkpoint exactly."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = VAETrainer(cfg, img_shape, device=device)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    log = MetricLog(cfg.run.out_dir, "vae_loss")
    prof = _Profiler(cfg.run, device)
    fixed_z = torch.randn(
        (64, cfg.latent_dim), device=device, generator=torch.Generator(
            device=device).manual_seed(cfg.run.seed + FIXED_Z_SEED_OFFSET))
    epochs = cfg.epochs if epochs is None else epochs
    gstep, n_val = trainer.step, 0
    od = cfg.run.out_dir
    for epoch in range(start_epoch, epochs):
        ramp = trainer.kl_ramp(epoch)
        t0 = time.perf_counter()
        total_dev, count = None, 0
        batches = device_prefetch((b for b, _ in train.epoch()), size=2,
                                  device=device)
        for i, batch in enumerate(batches):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            prof.step(gstep)
            m = trainer.train_step(batch, ramp, generator=gen)
            gstep += 1
            count += 1
            total_dev = m["total"] if total_dev is None \
                else total_dev + m["total"]
        total = float(total_dev) if count else 0.0
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)

        vgen = torch.Generator(device=device).manual_seed(
            cfg.run.seed + VAE_VAL_SEED_OFFSET)
        rows, ns, panel = [], [], None
        for vbatch, n in val.epoch():
            vb = torch.from_numpy(vbatch).to(device)
            ev = trainer.eval_step(vb, vgen)
            img = to_signed(vb)
            # only the true rows of a padded final batch count
            ru, iu = signed_to_unit(ev["recon"][:n]), signed_to_unit(img[:n])
            rows.append(torch.stack([ev["per_mse"][:n].mean(),
                                     ev["per_kl"][:n].sum(),
                                     mse_metric(ru, iu), psnr(ru, iu),
                                     ssim(ru, iu)]))
            ns.append(n)
            if panel is None:
                panel = (ev["noisy"], img, ev["recon"])
        n_val = sum(ns)
        vals = torch.stack(rows).double().cpu().tolist() if rows else []
        n_b = max(n_val, 1)

        def weighted(j):
            return sum(v[j] * n for v, n in zip(vals, ns)) / n_b
        row = dict(train_loss=total / max(count, 1),
                   val_loss=sum((v[0] + v[1]) * n for v, n in zip(vals, ns))
                   / n_b, images_per_sec=ips, mse=weighted(2),
                   psnr=weighted(3), ssim=weighted(4))
        log.append(epoch=epoch, **row)
        print(f"[vae] epoch {epoch + 1}/{epochs} train={row['train_loss']:.4f}"
              f" val={row['val_loss']:.4f} psnr={row['psnr']:.2f} "
              f"ssim={row['ssim']:.4f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            ckpt.save(epoch + 1, trainer.state_dict(), to_dict(cfg),
                      opt_state=trainer.opt.state_dict(),
                      rng_state=gen.get_state(), opt_step=trainer.step)
        if panel is not None:     # the val split can be empty on tiny data
            save_triplets(*panel, os.path.join(
                od, f"vae_valimg_epoch_{epoch + 1:04d}.npy"))
        save_grid(trainer.generate(fixed_z), os.path.join(
            od, f"vae_fake_epoch_{epoch + 1:04d}.npy"))
        epoch_metrics(log, "vae_")
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def evaluate_vae_checkpoints(cfg: VAEConfig, feature_fn=None,
                             max_checkpoints: Optional[int] = None,
                             max_encode_batches: Optional[int] = None,
                             max_eval_batches: Optional[int] = None,
                             device="cuda") -> list:
    """Aggregated-posterior sweep: for every saved checkpoint (the last
    ``max_checkpoints``), encode the train and val splits (at most
    ``max_encode_batches`` batches of each), build per-dimension empirical
    CDFs of (mu, logvar), inverse-transform sample one batch per val batch,
    reparameterize (eps from a generator seeded from the run seed, the same
    draws for every checkpoint), decode, and score SSIM (and, with
    ``feature_fn``, FID / IS / P-R) against the val batch over its true
    rows. Saves one grid per checkpoint
    (``vae_aggpost_step_<s>.npy``) and ``vae_eval_metrics.npz``."""
    device = resolve_device(device)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = VAETrainer(cfg, img_shape, device=device)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"))
    steps = ckpt.all_steps()
    if max_checkpoints:
        steps = steps[-max_checkpoints:]

    @torch.no_grad()
    def encode(batch_uint8):      # raw (mu, logvar), as the JAX sweep's
        return trainer.encoder(to_signed(torch.from_numpy(batch_uint8).to(
            device)), train=False)
    results = []
    for s in steps:
        _restored(trainer, ckpt.directory, s)
        sampler = aggregated_posterior_sampler(
            encode, [train, val], seed=cfg.run.seed,
            max_batches=max_encode_batches)
        gen = torch.Generator(device=device).manual_seed(cfg.run.seed)
        acc, grid = MetricAccumulator(feature_fn=feature_fn), None
        for j, (vbatch, n_valid) in enumerate(val.epoch()):
            if max_eval_batches is not None and j >= max_eval_batches:
                break
            mu, logvar = (torch.from_numpy(a).to(device)
                          for a in sampler(len(vbatch)))
            z, _ = reparameterize(mu, logvar, torch.randn(
                mu.shape, generator=gen, device=device))
            fake = trainer.generate(z)
            real = to_signed(torch.from_numpy(vbatch).to(device))
            acc.update(signed_to_unit(fake), signed_to_unit(real),
                       n_valid=n_valid)
            if grid is None:
                grid = fake
        row = {"step": s, **acc.compute()}
        results.append(row)
        if grid is not None:
            save_grid(grid, os.path.join(cfg.run.out_dir,
                                         f"vae_aggpost_step_{s:06d}.npy"))
        print(f"[eval-vae] ckpt {s}: " + " ".join(
            f"{k}={v:.4f}" for k, v in row.items() if k != "step"))
    np.savez(os.path.join(cfg.run.out_dir, "vae_eval_metrics.npz"),
             results=np.array([list(r.values()) for r in results]),
             columns=np.array(list(results[0].keys()) if results else []))
    return results


def evaluate_vae_occlusion(cfg: VAEConfig, max_batches: Optional[int] = None,
                           renoise_cycles: int = 2, step: Optional[int] = None,
                           device="cuda") -> Dict[str, float]:
    """Occlusion test: per val batch (true rows only), (occluded + noisy,
    clean) pairs from ``corrupt``, then the latest (or given) checkpoint's
    sum-reduction test loss (averaged over batches) and MSE / PSNR / SSIM
    (weighted by rows); the first batch's noisy / clean / reconstruction
    triplets, re-noise cycles and mu / logvar traversal strips as ``.npy``
    and the metrics as ``occlusion_metrics.npz``. Every draw comes, in
    that order, from the generator seeded with the run seed."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_vae(cfg, step, device)
    sums: Dict[str, float] = {}
    n_b, n_s, first = 0, 0, None
    for j, (vbatch, n_valid) in enumerate(val.epoch()):
        if max_batches is not None and j >= max_batches:
            break
        # the padded repeats go before the corruption
        clean = to_signed(torch.from_numpy(vbatch).to(device))[:n_valid]
        noisy = corrupt(clean, trainer.noise_std,
                        corrupt_draws(clean.shape, gen, device))
        m = denoise_test_loss(trainer, noisy, clean, generator=gen)
        recon = m.pop("recon")
        sums["test_loss"] = sums.get("test_loss", 0.0) + m.pop("test_loss")
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v * n_valid
        n_b += 1
        n_s += n_valid
        if first is None:
            first = (noisy, clean, recon)
    out = {"test_loss": sums.pop("test_loss", 0.0) / max(n_b, 1)}
    out.update({k: v / max(n_s, 1) for k, v in sums.items()})
    if first is None:           # empty val split (tiny datasets)
        return out
    od = cfg.run.out_dir
    save_triplets(*first, os.path.join(od, "occlusion_triplets.npy"))
    cycles = renoise_cycle(trainer, first[0], cycles=renoise_cycles,
                           generator=gen)
    save_triplets(first[0], cycles[0], cycles[-1],
                  os.path.join(od, "occlusion_renoise_cycles.npy"))
    for target in ("mu", "logvar"):
        frames = latent_traversal(trainer, first[0][:1], target=target,
                                  generator=gen)
        save_grid(frames, os.path.join(od,
                                       f"occlusion_traversal_{target}.npy"))
    np.savez(os.path.join(od, "occlusion_metrics.npz"), **out)
    print("[eval-vae --occlusion] " +
          " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def denoise_images(cfg: VAEConfig, ckpt_dir: str, images_uint8: np.ndarray,
                   seed: int = 42, device="cuda") -> np.ndarray:
    """Restore uint8 images (N, H, W, 3) at ``cfg.data.image_size`` with the
    latest VAE checkpoint under ``ckpt_dir``: encode -> reparameterize with
    one eps (1, latent) drawn from ``seed`` and shared by every image ->
    decode, eval mode. Returns uint8 (N, H, W, 3)."""
    trainer = _restored(VAETrainer(cfg, _image_shape(cfg), device=device),
                        ckpt_dir)
    dev = trainer.device
    eps = torch.randn((1, cfg.latent_dim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    out = trainer.denoise(to_signed(torch.from_numpy(
        np.ascontiguousarray(images_uint8)).to(dev)), eps)
    return torch.clamp((out + 1.0) * 127.5, 0, 255).to(torch.uint8).cpu() \
        .numpy()


def restore_gan(cfg: GANConfig, step: Optional[int] = None,
                device="cuda") -> GANTrainer:
    """A DCGAN / WGAN trainer on ``device`` with the latest (or given)
    checkpoint of ``<out_dir>/ckpt`` loaded (weights and BN running
    stats)."""
    return _restored(GANTrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


@_debug_nans
def run_gan(cfg: GANConfig, epochs: Optional[int] = None,
            max_steps_per_epoch: Optional[int] = None, resume: bool = False,
            device="cuda") -> Dict:
    """Train DCGAN (or WGAN with ``cfg.wgan``): per epoch, ``train_step``
    (``train_step_wgan``) over ``device_prefetch``ed batches (both losses
    summed on the device and read once), a ``MetricLog`` row (d_loss,
    g_loss, images_per_sec), every ``checkpoint_every_epochs`` a checkpoint
    of both networks (BN buffers included), both Adam states, the
    optimizer step and the generator state at step = epochs done, and the
    fixed-z grid (``.npy``). ``resume`` continues from the latest
    checkpoint exactly."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = GANTrainer(cfg, img_shape, device=device)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start_epoch = payload["step"]
        train.set_epoch(start_epoch)
        print(f"[checkpoint] resumed at epoch {start_epoch}")
    name = "wgan" if cfg.wgan else "gan"
    log = MetricLog(cfg.run.out_dir, "gan_loss")
    prof = _Profiler(cfg.run, device)
    fixed_z = torch.randn(
        (64, cfg.latent_dim), device=device, generator=torch.Generator(
            device=device).manual_seed(cfg.run.seed + FIXED_Z_SEED_OFFSET))
    step_fn = trainer.train_step_wgan if cfg.wgan else trainer.train_step
    epochs = cfg.epochs if epochs is None else epochs
    gstep = trainer.step
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        sums, count = {}, 0
        batches = device_prefetch((b for b, _ in train.epoch()), size=2,
                                  device=device)
        for i, batch in enumerate(batches):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            prof.step(gstep)
            m = step_fn(batch, gen)
            gstep += 1
            count += 1
            sums = {k: v + sums[k] if k in sums else v for k, v in m.items()}
        means = {k: float(v) / max(count, 1) for k, v in sums.items()}
        ips = count * cfg.data.batch_size / max(time.perf_counter() - t0,
                                                1e-9)
        log.append(epoch=epoch, **means, images_per_sec=ips)
        print(f"[{name}] epoch {epoch + 1}/{epochs} "
              f"D={means.get('d_loss', 0.0):.4f} "
              f"G={means.get('g_loss', 0.0):.4f} {ips:.0f} img/s")
        if (epoch + 1) % cfg.run.checkpoint_every_epochs == 0:
            ckpt.save(epoch + 1, trainer.state_dict(), to_dict(cfg),
                      opt_state=trainer.opt_state(),
                      rng_state=gen.get_state(), opt_step=trainer.step)
        save_grid(trainer.generate(fixed_z), os.path.join(
            cfg.run.out_dir, f"{name}_fake_epoch_{epoch + 1:04d}.npy"))
        epoch_metrics(log, "gan_")
    prof.close()
    return {"trainer": trainer, "log": log.history, "val": val}


def evaluate_gan_checkpoints(cfg: GANConfig, feature_fn=None,
                             max_checkpoints: Optional[int] = None,
                             device="cuda") -> list:
    """For every saved checkpoint (the last ``max_checkpoints``), one batch
    of prior samples per val batch (z from a generator seeded from the run
    seed, the same draws for every checkpoint) scored by SSIM (and, with
    ``feature_fn``, FID / IS / P-R) against it over its true rows;
    ``metrics.npz``."""
    device = resolve_device(device)
    _, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = GANTrainer(cfg, img_shape, device=device)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"))
    steps = ckpt.all_steps()
    if max_checkpoints:
        steps = steps[-max_checkpoints:]
    results = []
    for s in steps:
        _restored(trainer, ckpt.directory, s)
        gen = torch.Generator(device=device).manual_seed(cfg.run.seed)
        acc = MetricAccumulator(feature_fn=feature_fn)
        for vbatch, n_valid in val.epoch():
            fake = trainer.generate(torch.randn(
                (len(vbatch), cfg.latent_dim), generator=gen, device=device))
            real = to_signed(torch.from_numpy(vbatch).to(device))
            acc.update(signed_to_unit(fake), signed_to_unit(real),
                       n_valid=n_valid)
        results.append({"step": s, **acc.compute()})
        print(f"[eval-gan] ckpt {s}: " + " ".join(
            f"{k}={v:.4f}" for k, v in results[-1].items() if k != "step"))
    np.savez(os.path.join(cfg.run.out_dir, "metrics.npz"),
             results=np.array([list(r.values()) for r in results]),
             columns=np.array(list(results[0].keys()) if results else []))
    return results


def restore_glow(cfg: GlowConfig, step: Optional[int] = None,
                 device="cuda") -> GlowTrainer:
    """A Glow trainer on ``device`` with the latest (or given) checkpoint of
    ``<out_dir>/ckpt`` loaded."""
    return _restored(GlowTrainer(cfg, _image_shape(cfg), device=device),
                     os.path.join(cfg.run.out_dir, "ckpt"), step)


@_debug_nans
def run_glow(cfg: GlowConfig, n_iter: Optional[int] = None,
             resume: bool = False, device="cuda") -> Dict:
    """Train Glow for ``n_iter`` iterations (default ``cfg.n_iter``) on an
    endless shuffled stream: the data-dependent ActNorm init on batch 0,
    then iteration i on batch i + 1; every ``sample_every_iters`` a grid of
    ``reverse(z_sample) * 2`` (fixed temperature z from seed + 7) as
    ``sample/<iter>.npy`` and a ``MetricLog`` row (iter, loss, log_p,
    logdet, images_per_sec); every ``checkpoint_every_iters`` and at the
    end a checkpoint of the model (buffers included), Adam, the generator
    and the iteration. ``resume`` continues from the latest checkpoint
    exactly: same parameters, moments, draws and stream position."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    train, val, img_shape = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = GlowTrainer(cfg, img_shape, device=device)
    trainer.init(gen)
    ckpt = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt"),
                        keep=cfg.run.keep_checkpoints)
    log = MetricLog(cfg.run.out_dir, "glow_loss")
    prof = _Profiler(cfg.run, device)
    z_sample = trainer.sample_z(torch.Generator(device=device).manual_seed(
        cfg.run.seed + FIXED_Z_SEED_OFFSET), cfg.n_samples)
    n_iter = cfg.n_iter if n_iter is None else n_iter
    sample_dir = os.path.join(cfg.run.out_dir, "sample")
    start = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start = payload["step"]
        print(f"[checkpoint] resumed at iteration {start}")
    # batch 0 goes to the ActNorm init and batch i + 1 to iteration i, so a
    # run resumed at `start` continues from batch start + 1
    batches = device_prefetch(train.stream(start + 1 if start else 0),
                              size=2, device=device)
    if start == 0:
        trainer.init_step(next(batches), gen)

    def save(step):
        ckpt.save(step, trainer.model.state_dict(), to_dict(cfg),
                  opt_state=trainer.opt.state_dict(),
                  rng_state=gen.get_state(), opt_step=trainer.step)
    t0 = time.perf_counter()
    for i in range(start, n_iter):
        prof.step(i)
        m = trainer.train_step(next(batches), gen)
        if (i + 1) % cfg.run.sample_every_iters == 0:
            save_grid(trainer.reverse(z_sample) * 2.0, os.path.join(
                sample_dir, f"{i + 1:06d}.npy"))
            ips = cfg.run.sample_every_iters * cfg.data.batch_size / \
                max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            log.append(iter=i + 1, loss=float(m["loss"]),
                       log_p=float(m["log_p"]), logdet=float(m["logdet"]),
                       images_per_sec=ips)
            print(f"[glow] iter {i + 1}/{n_iter} loss={float(m['loss']):.4f}"
                  f" {ips:.0f} img/s")
        if (i + 1) % cfg.run.checkpoint_every_iters == 0:
            save(i + 1)
    if ckpt.latest_step() != n_iter:      # always leave a final checkpoint
        save(n_iter)
    prof.close()
    epoch_metrics(log, "glow_")
    return {"trainer": trainer, "log": log.history, "val": val}


def evaluate_glow(cfg: GlowConfig, trainer: GlowTrainer, val,
                  feature_fn=None, max_batches: Optional[int] = None
                  ) -> Dict[str, float]:
    """Temperature samples, one batch per val batch, scored by SSIM (and,
    with ``feature_fn``, FID / IS / P-R) against it: fake in [-0.5, 0.5]
    mapped to clip(fake + 0.5, 0, 1), real uint8 / 255, true rows only."""
    gen = seed_all(cfg.run.seed, trainer.device)
    acc = MetricAccumulator(feature_fn=feature_fn)
    for j, (vbatch, n_valid) in enumerate(val.epoch()):
        if max_batches is not None and j >= max_batches:
            break
        fake = trainer.reverse(trainer.sample_z(gen, len(vbatch)))
        real = torch.from_numpy(vbatch).to(trainer.device).float() / 255.0
        acc.update(torch.clamp(fake + 0.5, 0.0, 1.0), real, n_valid=n_valid)
    return acc.compute()


def evaluate_glow_from_dir(cfg: GlowConfig, feature_fn=None,
                           max_batches: Optional[int] = None,
                           step: Optional[int] = None,
                           device="cuda") -> Dict[str, float]:
    """Restore the latest (or given) Glow checkpoint and run
    ``evaluate_glow`` on the val split."""
    device = resolve_device(device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_glow(cfg, step, device)
    out = evaluate_glow(cfg, trainer, val, feature_fn=feature_fn,
                        max_batches=max_batches)
    np.savez(os.path.join(cfg.run.out_dir, "glow_eval_metrics.npz"), **out)
    print("[eval-glow] " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def load_feature_fn(enabled: bool, weights_path: Optional[str] = None,
                    feature: str = "64", device="cuda"):
    """(feature_fn, tag) of ``eval.inception.load_inception`` on
    ``device`` for FID / IS / P-R, or (None, None) when neither asked for
    nor given weights."""
    if not enabled and weights_path is None:
        return None, None
    from vgd_tpu_torch.eval.inception import load_inception
    return load_inception(weights_path, feature=feature, device=device)


def _eeg_ckpt_dir(cfg: GlowEEGConfig) -> str:
    return os.path.join(cfg.run.out_dir, f"ckpt_{cfg.event_type}")


def restore_glow_eeg(cfg: GlowEEGConfig, step: Optional[int] = None,
                     device="cuda") -> GlowEEGTrainer:
    """An EEG Glow trainer on ``device`` with the latest (or given)
    checkpoint of ``<out_dir>/ckpt_<event_type>`` loaded."""
    return _restored(GlowEEGTrainer(cfg, device=device), _eeg_ckpt_dir(cfg),
                     step)


def _eeg_trials(x: torch.Tensor) -> np.ndarray:
    """(N, T, 1, C) flow samples as (N, C, T) numpy, the reference's dump
    layout."""
    return x[:, :, 0, :].permute(0, 2, 1).float().cpu().numpy()


def sample_eeg(trainer: GlowEEGTrainer, n: int, seed: int = 42
               ) -> np.ndarray:
    """``n`` trials (N, C, T) of the flow at its temperature, z drawn from
    ``seed``."""
    z = trainer.sample_z(seed_all(seed, trainer.device), n)
    return _eeg_trials(trainer.reverse(z))


@_debug_nans
def run_glow_eeg(cfg: GlowEEGConfig, n_iter: Optional[int] = None,
                 resume: bool = False, device="cuda") -> Dict:
    """Train the EEG Glow of one event type for ``n_iter`` iterations
    (default ``cfg.n_iter``) on an endless shuffled stream of the T
    session's trials: the ActNorm init on batch 0, then iteration i on batch
    i + 1; every ``sample_every_iters`` the fixed temperature z's trials as
    ``sample/fake_eeg_<event>_training_<iter>.npz`` (N, C, T), a trace PNG
    of the first where matplotlib is installed, and a ``MetricLog`` row;
    every ``checkpoint_every_iters`` and at the end a checkpoint under
    ``ckpt_<event>`` of the model, Adam, the generator and the iteration.
    ``resume`` continues from the latest checkpoint exactly (parameters,
    moments, draws, stream position). Then ``eeg_psd_and_gif``; a failure
    there is printed and does not undo the finished run."""
    device = resolve_device(device)
    gen = seed_all(cfg.run.seed, device)
    ds = EEGDataset(path=cfg.eeg_path, dataset_type="T",
                    event_type=cfg.event_type, seed=cfg.run.seed)
    trainer = GlowEEGTrainer(cfg, device=device)
    trainer.init(gen)
    ckpt = Checkpointer(_eeg_ckpt_dir(cfg), keep=cfg.run.keep_checkpoints)
    log = MetricLog(cfg.run.out_dir, f"eeg_{cfg.event_type}")
    prof = _Profiler(cfg.run, device)
    z_sample = trainer.sample_z(torch.Generator(device=device).manual_seed(
        cfg.run.seed + FIXED_Z_SEED_OFFSET), cfg.n_samples)
    n_iter = cfg.n_iter if n_iter is None else n_iter
    sample_dir = os.path.join(cfg.run.out_dir, "sample")
    os.makedirs(sample_dir, exist_ok=True)
    start = 0
    if resume and ckpt.latest_step() is not None:
        payload = ckpt.load(map_location=device)
        trainer.load(payload["params"], payload["opt_state"],
                     payload["opt_step"])
        gen.set_state(payload["rng_state"])
        start = payload["step"]
        print(f"[checkpoint] resumed at iteration {start}")
    # batch 0 goes to the ActNorm init and batch i + 1 to iteration i
    batches = device_prefetch(eeg_batches(
        ds, cfg.batch_size, seed=cfg.run.seed,
        skip=start + 1 if start > 0 else 0), size=2, device=device)
    if start == 0:
        trainer.init_step(next(batches), gen)
    draw = have_matplotlib()
    if not draw:
        print(f"[glow-eeg:{cfg.event_type}] matplotlib is not installed: "
              f"samples are written as .npz only, no trace PNG")

    def save(step):
        ckpt.save(step, trainer.model.state_dict(), to_dict(cfg),
                  opt_state=trainer.opt.state_dict(),
                  rng_state=gen.get_state(), opt_step=trainer.step)
    t0 = time.perf_counter()
    for i in range(start, n_iter):
        prof.step(i)
        m = trainer.train_step(next(batches), gen)
        if (i + 1) % cfg.run.sample_every_iters == 0:
            arr = _eeg_trials(trainer.reverse(z_sample))
            name = f"fake_eeg_{cfg.event_type}_training_{i + 1}"
            np.savez(os.path.join(sample_dir, f"{name}.npz"), arr)
            if draw:
                plot_eeg_signals(arr, os.path.join(sample_dir, f"{name}.png"),
                                 channel_names=CHANNEL_NAMES)
            tps = cfg.run.sample_every_iters * cfg.batch_size / \
                max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            log.append(iter=i + 1, loss=float(m["loss"]),
                       trials_per_sec=tps)
            print(f"[glow-eeg:{cfg.event_type}] iter {i + 1}/{n_iter} "
                  f"loss={float(m['loss']):.4f} {tps:.0f} trials/s")
        if (i + 1) % cfg.run.checkpoint_every_iters == 0:
            save(i + 1)
    if ckpt.latest_step() != n_iter:      # always leave a final checkpoint
        save(n_iter)
    prof.close()
    epoch_metrics(log, f"eeg_{cfg.event_type}_")
    try:
        eeg_psd_and_gif(cfg, trainer=trainer, dataset=ds)
    except Exception as e:  # noqa: BLE001 - artifacts, not the run
        print(f"[glow-eeg] post-training artifacts failed: "
              f"{type(e).__name__}: {e}")
    return {"trainer": trainer, "log": log.history}


def eeg_psd_and_gif(cfg: GlowEEGConfig, trainer: Optional[GlowEEGTrainer]
                    = None, dataset: Optional[EEGDataset] = None,
                    n_fake: int = 64, step: Optional[int] = None,
                    device="cuda") -> Dict[str, str]:
    """The real-vs-generated PSD comparison: ``n_fake`` temperature samples
    (z from seed + EEG_PSD_SEED_OFFSET; non-finite trials dropped) against
    the T session's trials, the welch PSD of their C3 / Cz / C4 average as
    ``psd_<event>.npz`` (freq, real, fake, n_real, n_fake) and, where
    matplotlib is installed, ``psd_comparison_<event>.jpg``; and the
    training-evolution GIF of the trace PNGs, where there are any. Restores
    the latest (or given) checkpoint when no trainer is given. Returns the
    paths ("" for what was not drawn)."""
    import glob

    if trainer is None:
        trainer = restore_glow_eeg(cfg, step, device)
    if dataset is None:
        dataset = EEGDataset(path=cfg.eeg_path, dataset_type="T",
                             event_type=cfg.event_type, seed=cfg.run.seed)
    z = trainer.sample_z(torch.Generator(device=trainer.device).manual_seed(
        cfg.run.seed + EEG_PSD_SEED_OFFSET), n_fake)
    fake = _eeg_trials(trainer.reverse(z))
    fake = fake[np.isfinite(fake).all(axis=(1, 2))]
    real = dataset.as_ncT()
    fx, psd_r = mean_central_psd(real)
    _, psd_f = mean_central_psd(fake)
    od, et = cfg.run.out_dir, cfg.event_type
    out = {"psd_npz": os.path.join(od, f"psd_{et}.npz"), "psd": "",
           "gif": ""}
    np.savez(out["psd_npz"], freq=fx, real=psd_r, fake=psd_f,
             n_real=len(real), n_fake=len(fake))
    if have_matplotlib():
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.semilogy(fx, psd_r, label=f"real (n={len(real)})")
        ax.semilogy(fx, psd_f, label=f"generated (n={len(fake)})")
        ax.set_xlabel("frequency [Hz]")
        ax.set_ylabel("PSD")
        ax.set_title(f"central-channel PSD, event '{et}'")
        ax.grid(True, alpha=0.3)
        ax.legend()
        out["psd"] = os.path.join(od, f"psd_comparison_{et}.jpg")
        fig.savefig(out["psd"], bbox_inches="tight", dpi=90)
        plt.close(fig)
    frames = sorted(
        glob.glob(os.path.join(od, "sample",
                               f"fake_eeg_{et}_training_*.png")),
        key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    if frames:
        out["gif"] = os.path.join(od, f"training_evolution_{et}.gif")
        save_gif(frames, out["gif"])
    print(f"[eval-eeg] psd={out['psd_npz']} figure={out['psd'] or '(none)'} "
          f"gif={out['gif'] or '(no frames)'}")
    return out


def sample_from_dir(family: str, cfg, n: int = 64,
                    out_path: Optional[str] = None,
                    step: Optional[int] = None, seed: int = 42,
                    ddim_steps: int = 0, ddim_eta: float = 0.0,
                    device="cuda") -> str:
    """Generate samples from a trained checkpoint; writes an (n, H, W, C)
    ``.npy`` in [-1, 1] (EEG: (n, C, T) trials, and a trace PNG of the
    first where matplotlib is installed) and returns its path.
    ``diffusion``: the DDIM chain (``ddim_steps > 0``) or the full
    ancestral chain from noise drawn from ``seed``; ``glow``: the reverse
    flow on temperature z drawn from ``seed``, times 2 (images in
    [-1, 1]); ``glow-eeg``: the reverse flow of ``ckpt_<event_type>`` on
    temperature z drawn from ``seed``; ``vaegan``, ``vae``, ``gan``,
    ``wgan``: the decoder / generator in eval mode on z (n, latent) drawn
    from ``seed``."""
    restore = {"vaegan": restore_vaegan, "vae": restore_vae,
               "gan": restore_gan, "wgan": restore_gan}
    if family not in ("diffusion", "glow", "glow-eeg", *restore):
        raise ValueError(f"unknown family {family!r}")
    od = cfg.run.out_dir
    out_path = out_path or os.path.join(od, f"{family}_samples.npy")
    if not out_path.endswith(".npy"):
        out_path += ".npy"
    if family in restore:
        trainer = restore[family](cfg, step, device)
        gen = seed_all(seed, trainer.device)
        z = torch.randn((n, cfg.latent_dim), generator=gen,
                        device=trainer.device)
        t0 = time.perf_counter()
        imgs = trainer.generate(z)
    elif family == "glow":
        trainer = restore_glow(cfg, step, device)
        z = trainer.sample_z(seed_all(seed, trainer.device), n)
        t0 = time.perf_counter()
        imgs = trainer.reverse(z) * 2.0
    elif family == "glow-eeg":
        trainer = restore_glow_eeg(cfg, step, device)
        z = trainer.sample_z(seed_all(seed, trainer.device), n)
        t0 = time.perf_counter()
        imgs = trainer.reverse(z)[:, :, 0, :].permute(0, 2, 1)
    else:
        trainer = restore_trainer(cfg, step, device)
        gen = seed_all(seed, trainer.device)
        x_t = torch.randn((n,) + _image_shape(cfg), generator=gen,
                          device=trainer.device)
        t0 = time.perf_counter()
        if ddim_steps > 0:
            imgs = trainer.ddim_sample(x_t, ddim_steps, eta=ddim_eta,
                                       generator=gen)
        else:
            imgs = trainer.ancestral_sample(x_t, cfg.timesteps - 1,
                                            generator=gen)
    imgs = imgs.cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.save(out_path, imgs)
    if family == "glow-eeg" and have_matplotlib():
        plot_eeg_signals(imgs, out_path[:-len(".npy")] + ".png",
                         channel_names=CHANNEL_NAMES)
    print(f"[sample] {family} checkpoint -> {out_path} "
          f"({time.perf_counter() - t0:.3f} s for {n} images)")
    return out_path
