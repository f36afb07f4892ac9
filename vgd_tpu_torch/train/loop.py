"""Entry points of the port (``vgd_tpu/train/loop.py``): DDPM training
(``run_diffusion``), VAE-GAN training (``run_vaegan``), Glow training
(``run_glow``) and its temperature-sampled SSIM evaluation
(``evaluate_glow``), sample grids from a checkpoint of any of them and
partial-noise restoration evaluation.

Grids and panels are written as ``.npy`` arrays in [-1, 1] (the JAX
package's image writer needs matplotlib/PIL, which the port does not
depend on). The JAX loop's mesh, sequence-parallel and epoch-scan options
have no counterpart here: the port runs one device and loops over steps
in Python.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from vgd_tpu_torch.core.config import (DiffusionConfig, GlowConfig,
                                       VAEGANConfig, to_dict)
from vgd_tpu_torch.core.rng import resolve_device, seed_all
from vgd_tpu_torch.data.celeba import make_image_datasets
from vgd_tpu_torch.eval.metrics import MetricAccumulator, mse_metric, psnr
from vgd_tpu_torch.io.artifacts import MetricLog, save_grid, save_triplets
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.ops.image import signed_to_unit, to_signed
from vgd_tpu_torch.train.diffusion import (DiffusionState, DiffusionTrainer,
                                           q_sample)
from vgd_tpu_torch.train.glow import GlowTrainer
from vgd_tpu_torch.train.vaegan import VAEGANTrainer
from vgd_tpu_torch.utils.prefetch import device_prefetch

# offset of the validation generator's seed from the run seed: every epoch
# scores the same t and noise draws, as the JAX loop folds a fixed
# 30_000 + j into its key for val batch j
VAL_SEED_OFFSET = 30_000
# the VAE-GAN loop's fixed grid latents and validation draws, likewise from
# fixed offsets (the JAX loop folds 7 and 10_000 + j into its key)
FIXED_Z_SEED_OFFSET = 7
VAEGAN_VAL_SEED_OFFSET = 10_000


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
    prof.close()
    log.save()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def evaluate_diffusion(cfg: DiffusionConfig, trainer: DiffusionTrainer, val,
                       max_batches: Optional[int] = None,
                       save_panels: bool = True) -> Dict[str, float]:
    """Restoration evaluation: noise each val batch to a seeded random
    start step, run the ancestral chain back, and score on [0, 1] images
    over the true rows (padded repeats of the last batch excluded): SSIM
    through ``MetricAccumulator`` and PSNR, as the reference returns them,
    and MSE beside them. With
    ``save_panels`` the first batch's original / noisy / multi-step /
    one-step panel is saved as ``diffusion_restore_panel.npy``."""
    gen = seed_all(cfg.run.seed, trainer.device)
    dev = trainer.device
    acc = MetricAccumulator()
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


def evaluate_diffusion_from_dir(cfg: DiffusionConfig,
                                max_batches: Optional[int] = None,
                                step: Optional[int] = None,
                                device="cuda") -> Dict[str, float]:
    """Restore the latest (or given) DDPM checkpoint and run the
    restoration evaluation on the val split."""
    device = resolve_device(device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_trainer(cfg, step, device)
    out = evaluate_diffusion(cfg, trainer, val, max_batches=max_batches)
    np.savez(os.path.join(cfg.run.out_dir, "diffusion_eval_metrics.npz"),
             **out)
    print("[eval-diffusion] " +
          " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def restore_vaegan(cfg: VAEGANConfig, step: Optional[int] = None,
                   device="cuda") -> VAEGANTrainer:
    """A VAE-GAN trainer on ``device`` with the latest (or given) checkpoint
    of ``<out_dir>/ckpt`` loaded (weights and BN running stats)."""
    trainer = VAEGANTrainer(cfg, _image_shape(cfg), device=device)
    params, s, _ = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt")).restore(
        step, map_location=trainer.device)
    trainer.load(params)
    print(f"[checkpoint] restored step {s}")
    return trainer


def run_vaegan(cfg: VAEGANConfig, epochs: Optional[int] = None,
               max_steps_per_epoch: Optional[int] = None,
               resume: bool = False, device="cuda") -> Dict:
    """Train the VAE-GAN: per epoch, ``train_step`` over
    ``device_prefetch``ed batches with the KL ramp of the epoch (the losses
    summed on the device and read once: epoch metrics are means over every
    step), then the denoising validation pass over the true rows of every
    val batch (val loss = mean(per_mse[:n]) + alpha_kl * sum(per_kl[:n]),
    weighted by n; PSNR; SSIM through ``MetricAccumulator``), a
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
        acc = MetricAccumulator()
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
    prof.close()
    log.save()
    return {"trainer": trainer, "log": log.history, "val": val,
            "val_rows": n_val}


def restore_glow(cfg: GlowConfig, step: Optional[int] = None,
                 device="cuda") -> GlowTrainer:
    """A Glow trainer on ``device`` with the latest (or given) checkpoint of
    ``<out_dir>/ckpt`` loaded."""
    trainer = GlowTrainer(cfg, _image_shape(cfg), device=device)
    params, s, _ = Checkpointer(os.path.join(cfg.run.out_dir, "ckpt")).restore(
        step, map_location=trainer.device)
    trainer.load(params)
    print(f"[checkpoint] restored step {s}")
    return trainer


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
    log.save()
    return {"trainer": trainer, "log": log.history, "val": val}


def evaluate_glow(cfg: GlowConfig, trainer: GlowTrainer, val,
                  max_batches: Optional[int] = None) -> Dict[str, float]:
    """Temperature samples, one batch per val batch, scored by SSIM against
    it: fake in [-0.5, 0.5] mapped to clip(fake + 0.5, 0, 1), real uint8 /
    255, true rows only. IS / FID wait for the eval slice."""
    gen = seed_all(cfg.run.seed, trainer.device)
    acc = MetricAccumulator()
    for j, (vbatch, n_valid) in enumerate(val.epoch()):
        if max_batches is not None and j >= max_batches:
            break
        fake = trainer.reverse(trainer.sample_z(gen, len(vbatch)))
        real = torch.from_numpy(vbatch).to(trainer.device).float() / 255.0
        acc.update(torch.clamp(fake + 0.5, 0.0, 1.0), real, n_valid=n_valid)
    return acc.compute()


def evaluate_glow_from_dir(cfg: GlowConfig, max_batches: Optional[int] = None,
                           step: Optional[int] = None,
                           device="cuda") -> Dict[str, float]:
    """Restore the latest (or given) Glow checkpoint and run
    ``evaluate_glow`` on the val split."""
    device = resolve_device(device)
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = restore_glow(cfg, step, device)
    out = evaluate_glow(cfg, trainer, val, max_batches=max_batches)
    np.savez(os.path.join(cfg.run.out_dir, "glow_eval_metrics.npz"), **out)
    print("[eval-glow] " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def sample_from_dir(family: str, cfg, n: int = 64,
                    out_path: Optional[str] = None,
                    step: Optional[int] = None, seed: int = 42,
                    ddim_steps: int = 0, ddim_eta: float = 0.0,
                    device="cuda") -> str:
    """Generate a sample grid from a trained checkpoint; writes an
    (n, H, W, C) ``.npy`` in [-1, 1] and returns its path. ``diffusion``:
    the DDIM chain (``ddim_steps > 0``) or the full ancestral chain from
    noise drawn from ``seed``; ``vaegan``: the decoder in eval mode on z
    (n, latent) drawn from ``seed``; ``glow``: the reverse flow on
    temperature z drawn from ``seed``, times 2 (images in [-1, 1])."""
    if family not in ("diffusion", "vaegan", "glow"):
        raise NotImplementedError(f"family {family!r} is not ported yet")
    od = cfg.run.out_dir
    out_path = out_path or os.path.join(od, f"{family}_samples.npy")
    if not out_path.endswith(".npy"):
        out_path += ".npy"
    if family == "vaegan":
        trainer = restore_vaegan(cfg, step, device)
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
    print(f"[sample] {family} checkpoint -> {out_path} "
          f"({time.perf_counter() - t0:.3f} s for {n} images)")
    return out_path
