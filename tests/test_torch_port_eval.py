"""The port's DDPM restoration evaluation against the JAX package's metrics:
``evaluate_diffusion`` returns the reference's keys (``ssim`` from a
``MetricAccumulator`` over the true rows, ``psnr`` over the true rows) and
``mse`` beside them; ssim and psnr are held to ``vgd_tpu.eval.metrics`` on
the same restored and real images, in f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.eval.metrics import MetricAccumulator as JMetricAccumulator
from vgd_tpu.eval.metrics import psnr as jpsnr
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.core.rng import seed_all
from vgd_tpu_torch.data.celeba import make_image_datasets
from vgd_tpu_torch.ops.image import signed_to_unit, to_signed
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.diffusion import DiffusionTrainer


@pytest.mark.parametrize("max_batches", [1, None])
def test_evaluate_diffusion_metrics_match_jax(tmp_path, max_batches):
    """46 images -> a val split of 5: a full batch of 4 and a padded one
    with 1 true row, so the true-row weighting matters."""
    cfg = PC.DiffusionConfig(
        data=PC.DataConfig(image_size=(16, 16), batch_size=4,
                           dataset_size=46),
        run=PC.RunConfig(out_dir=str(tmp_path), compute_dtype="float32"),
        timesteps=8, base_ch=8, time_emb_dim=32)
    trainer = DiffusionTrainer(cfg, (16, 16, 3), device="cpu")
    trainer.init(seed_all(0, "cpu"))
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    restored = []
    chain = trainer.ancestral_sample

    def recording(*args, **kwargs):
        out = chain(*args, **kwargs)
        restored.append(out.detach().clone())
        return out
    trainer.ancestral_sample = recording
    out = L.evaluate_diffusion(cfg, trainer, val, max_batches=max_batches,
                               save_panels=False)
    assert set(out) == {"ssim", "psnr", "mse"}

    acc = JMetricAccumulator()
    psnr_sum, rows = 0.0, 0
    batches = list(val.epoch())[:len(restored)]
    assert len(batches) == (1 if max_batches else 2)
    for fake, (vbatch, n_valid) in zip(restored, batches):
        fake_unit = jnp.asarray(signed_to_unit(fake).numpy())
        real_unit = jnp.asarray(signed_to_unit(
            to_signed(torch.from_numpy(vbatch))).numpy())
        acc.update(fake_unit, real_unit, n_valid=n_valid)
        psnr_sum += float(jpsnr(fake_unit[:n_valid],
                                real_unit[:n_valid])) * n_valid
        rows += n_valid
    want = acc.compute()
    np.testing.assert_allclose(out["ssim"], want["ssim"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out["psnr"], psnr_sum / rows, rtol=1e-5)
    assert out["mse"] > 0
