"""Port serving path end to end on the CPU (checkpoint -> sample grid,
checkpoint -> restoration evaluation, the CLI), and the package rules:
no JAX / Flax / vgd_tpu import anywhere in the port or in chip_smoke.py,
no library attention or group-norm call, and entry points that refuse to
run without a card unless ``device="cpu"`` is given."""
import ast
import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch

from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.core.rng import resolve_device, seed_all
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.diffusion import DiffusionTrainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vgd_tpu")


def _cfg(out_dir):
    return PC.DiffusionConfig(
        data=PC.DataConfig(image_size=(16, 16), batch_size=4,
                           dataset_size=40),
        run=PC.RunConfig(out_dir=str(out_dir), compute_dtype="float32"),
        timesteps=8, base_ch=8, time_emb_dim=32)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory holding one seeded checkpoint of a tiny model."""
    out = tmp_path_factory.mktemp("diffusion")
    cfg = _cfg(out)
    tr = DiffusionTrainer(cfg, (16, 16, 3), device="cpu")
    tr.init(seed_all(0, "cpu"))
    L.save_checkpoint(cfg, tr, step=1)
    return out


@pytest.mark.parametrize("ddim_steps", [0, 3])
def test_sample_from_dir_cpu(run_dir, ddim_steps):
    cfg = _cfg(run_dir)
    path = L.sample_from_dir("diffusion", cfg, n=2, ddim_steps=ddim_steps,
                             device="cpu")
    imgs = np.load(path)
    assert imgs.shape == (2, 16, 16, 3) and np.isfinite(imgs).all()
    assert np.abs(imgs).max() <= 1.0
    again = np.load(L.sample_from_dir("diffusion", cfg, n=2,
                                      ddim_steps=ddim_steps, device="cpu"))
    np.testing.assert_array_equal(imgs, again)       # seeded


def test_evaluate_diffusion_from_dir_cpu(run_dir):
    """The reference's keys (SSIM, PSNR over the true val rows) and MSE;
    the restore panel holds original / noisy / multi-step / one-step."""
    cfg = _cfg(run_dir)
    out = L.evaluate_diffusion_from_dir(cfg, max_batches=1, device="cpu")
    assert set(out) == {"ssim", "psnr", "mse"}
    assert -1.0 <= out["ssim"] <= 1.0
    assert math.isfinite(out["psnr"]) and out["mse"] > 0
    np.testing.assert_allclose(out["psnr"], 10 * np.log10(1 / out["mse"]),
                               rtol=0.5)
    panel = np.load(run_dir / "diffusion_restore_panel.npy")
    assert panel.shape == (4, 4, 16, 16, 3)
    assert np.abs(panel[2:]).max() <= 1.0


def test_cli_cpu(tmp_path, capsys):
    """The CLI at the default width (base_ch 64), on 16x16 images, T=8."""
    cfg = PC.DiffusionConfig(
        data=PC.DataConfig(image_size=(16, 16), batch_size=4,
                           dataset_size=40),
        run=PC.RunConfig(out_dir=str(tmp_path), compute_dtype="float32"),
        timesteps=8)
    tr = DiffusionTrainer(cfg, (16, 16, 3), device="cpu")
    tr.init(seed_all(0, "cpu"))
    L.save_checkpoint(cfg, tr, step=5)
    common = ["--out-dir", str(tmp_path), "--image-size", "16",
              "--batch-size", "4", "--dataset-size", "40", "--timesteps",
              "8", "--compute-dtype", "float32", "--device", "cpu"]
    assert cli.main(["sample", "--family", "diffusion", "-n", "2",
                     "--ddim-steps", "2"] + common) == 0
    imgs = np.load(tmp_path / "diffusion_samples.npy")
    assert imgs.shape == (2, 16, 16, 3) and np.abs(imgs).max() <= 1.0
    assert cli.main(["eval-diffusion", "--max-batches", "1"] + common) == 0
    assert "restored step 5" in capsys.readouterr().out
    # a checkpoint of another width is refused, never half-loaded
    with pytest.raises(RuntimeError):
        L.sample_from_dir("diffusion", dataclasses.replace(cfg, base_ch=8),
                          n=2, device="cpu")


@pytest.mark.parametrize("cmd,runner,cfg_cls", [
    ("glow", "run_glow", PC.GlowConfig),
    ("vaegan", "run_vaegan", PC.VAEGANConfig),
    ("diffusion", "run_diffusion", PC.DiffusionConfig)])
@pytest.mark.parametrize("given", [True, False])
def test_cli_training_commands_take_lr_and_keep_checkpoints(
        monkeypatch, cmd, runner, cfg_cls, given):
    """Every training command takes --lr and --keep-checkpoints, as each of
    the reference's does, and the values reach the config it trains;
    without them the config's defaults stand."""
    seen = []
    monkeypatch.setattr(L, runner, lambda cfg, **kw: seen.append(cfg))
    flags = ["--lr", "1e-3", "--keep-checkpoints", "5"] if given else []
    assert cli.main([cmd, "--device", "cpu"] + flags) == 0
    (cfg,) = seen
    default = cfg_cls()
    assert cfg.lr == (1e-3 if given else default.lr)
    assert cfg.run.keep_checkpoints == \
        (5 if given else default.run.keep_checkpoints)


def test_no_jax_import_in_port():
    """No JAX-side import in the package or chip_smoke.py, the native
    gather's bindings among them, and no load of the JAX package's gather
    library; no library attention, group norm or torch.compile inside the
    package (chip_smoke.py times the library calls as a yardstick only)."""
    package = sorted((ROOT / "vgd_tpu_torch").rglob("*.py"))
    files = package + [ROOT / "chip_smoke.py"]
    assert ROOT / "vgd_tpu_torch" / "data" / "native.py" in package
    bad = []
    for f in files:
        if "libvgdgather" in f.read_text():
            bad.append(f"{f.relative_to(ROOT)}: libvgdgather")
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
            if f in package and isinstance(node, ast.Attribute) and (
                    node.attr in ("scaled_dot_product_attention",
                                  "group_norm")
                    or (node.attr == "compile"
                        and getattr(node.value, "id", "") == "torch")):
                bad.append(f"{f.relative_to(ROOT)}: .{node.attr}")
    assert len(files) > 10 and not bad, bad


def test_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionTrainer(cfg, (16, 16, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.sample_from_dir("diffusion", cfg, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.evaluate_diffusion_from_dir(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seed_all(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval-diffusion", "--out-dir", str(tmp_path)])
    assert resolve_device("cpu").type == "cpu"
