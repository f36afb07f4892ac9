"""Serving export of the port (``vgd_tpu_torch/io/export.py``) on the CPU:
the cases of ``tests/test_export.py`` on the port's artifacts, and each
family's artifact held against the JAX package's ``run_artifact`` with
JAX's own threefry draws fed into the port's program (the same weights on
both sides, bridged from the JAX state).

Tolerances (f32 on both sides): the VAE decoder and denoiser atol 1e-5;
DDPM DDIM (4 steps, eta 0) and ancestral (T=8) atol 1e-3, as the samplers'
parity tests (each UNet forward agrees to 2e-4, and the chain carries
it); Glow's reverse 1e-5 of the largest |value|, as the model's parity
test. Every exported diffusion step and Glow reverse holds the ``vgd::``
op nodes (3 K3 and 14 K4 a UNet forward, one K5 a flow) and none of
their plain arithmetic.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_unet import jax_params
from vgd_tpu.core import config as JC
from vgd_tpu.io import export as JE
from vgd_tpu.train import diffusion as JD
from vgd_tpu.train.glow import GlowTrainer as JGT
from vgd_tpu.train.vae import VAETrainer as JVT
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.io.export import (build_serving_fn, export_serving,
                                     load_artifact, run_artifact,
                                     serving_draws)
from vgd_tpu_torch.io.jax_params import (load_jax_glow_state,
                                         load_jax_params, load_jax_vae_state)
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.diffusion import DiffusionTrainer
from vgd_tpu_torch.train.glow import GlowTrainer
from vgd_tpu_torch.train.vae import VAETrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two torch threads: the suite runs several test files at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _key(seed):
    return jax.random.key(seed, impl="threefry2x32")


def _jax_artifact(fn, args, path):
    JE.export_artifact(fn, args, path, platforms=("cpu",))
    return path


# ---------------------------------------------------------------- the VAE
# a narrow VAE (the CLI tests build their VAEConfig with these widths too)
VAE_WIDTHS = dict(latent_dim=16, ngf=8)


@pytest.fixture(scope="module")
def vae(tmp_path_factory):
    """(port config, JAX trainer, JAX state): the JAX package's seeded VAE
    (64x64, latent 16, ngf 8, f32) bridged into a port checkpoint."""
    out = tmp_path_factory.mktemp("export_vae")
    data = dict(image_size=(64, 64), batch_size=4, dataset_size=16)
    jcfg = JC.VAEConfig(data=JC.DataConfig(**data),
                        run=JC.RunConfig(compute_dtype="float32"),
                        **VAE_WIDTHS)
    pcfg = PC.VAEConfig(data=PC.DataConfig(**data),
                        run=PC.RunConfig(out_dir=str(out),
                                         compute_dtype="float32"),
                        **VAE_WIDTHS)
    jt = JVT(jcfg, (64, 64, 3))
    state = jax.jit(jt.init, static_argnums=1)(jax.random.PRNGKey(0), 4)
    tr = VAETrainer(pcfg, (64, 64, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    load_jax_vae_state(tr, jax.device_get(state))
    Checkpointer(os.path.join(out, "ckpt")).save(
        3, tr.state_dict(), PC.to_dict(pcfg))
    return pcfg, jt, state


def _restored(cfg):
    return L.restore_vae(cfg, device="cpu")


@pytest.fixture
def narrow_cli(monkeypatch):
    """The CLI's VAEConfig at the fixture's widths (the CLI has no width
    flags, as in the JAX package)."""
    monkeypatch.setattr(cli.C, "VAEConfig",
                        functools.partial(PC.VAEConfig, **VAE_WIDTHS))


def test_export_sample_roundtrip_matches_direct(vae):
    cfg = vae[0]
    path = export_serving("vae", cfg, n=4, platforms=("cpu",),
                          artifact_path=os.path.join(cfg.run.out_dir,
                                                     "art.pt2"))
    assert os.path.exists(path) and os.path.exists(path + ".json")
    call, meta = load_artifact(path, device="cpu")
    assert meta["family"] == "vae" and meta["mode"] == "sample"
    assert meta["step"] == 3 and meta["n"] == 4
    out = run_artifact(seed=7, loaded=(call, meta))
    assert out.shape == (4, 64, 64, 3) and np.isfinite(out).all()
    # deterministic per seed, distinct across seeds
    np.testing.assert_array_equal(out, run_artifact(path, 7, device="cpu"))
    assert not np.array_equal(out, run_artifact(seed=8,
                                                loaded=(call, meta)))
    # the in-process inference path, same params, same draws
    fn, _ = build_serving_fn("vae", cfg, _restored(cfg), 4)
    with torch.no_grad():
        want = fn(serving_draws(meta, 7)["z"])
    np.testing.assert_allclose(out, want.numpy(), rtol=0, atol=1e-5)


def test_export_denoise_mode(vae):
    cfg = vae[0]
    path = export_serving("vae", cfg, n=2, mode="denoise",
                          platforms=("cpu",),
                          artifact_path=os.path.join(cfg.run.out_dir,
                                                     "den.pt2"))
    x = np.clip(np.random.default_rng(0).normal(0, 0.3, (2, 64, 64, 3)),
                -1, 1).astype(np.float32)
    out = run_artifact(path, seed=3, inputs=x, device="cpu")
    assert out.shape == x.shape and np.isfinite(out).all()
    trainer = _restored(cfg)
    eps = serving_draws(load_artifact(path, "cpu")[1], 3, batch=2)["eps"]
    want = trainer.denoise(torch.from_numpy(x), eps)
    np.testing.assert_allclose(out, want.numpy(), rtol=0, atol=1e-5)


def test_vae_artifacts_match_jax_run_artifact(vae, tmp_path):
    """Sample and denoise: JAX's artifact on its threefry draws, the
    port's on the same draws (atol 1e-5)."""
    cfg, jt, state = vae
    seed, n = 5, 3
    jfn, jargs = JE.build_serving_fn("vae", jt.cfg, jt, state, n)
    want = JE.run_artifact(_jax_artifact(jfn, jargs,
                                         str(tmp_path / "s.jaxexport")), seed)
    z = np.asarray(jax.random.normal(_key(seed), (n, cfg.latent_dim)))
    path = export_serving("vae", cfg, n=n, platforms=("cpu",),
                          artifact_path=str(tmp_path / "s.pt2"))
    got = run_artifact(path, seed, draws={"z": z}, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    x = np.clip(np.random.default_rng(1).normal(0, 0.4, (n, 64, 64, 3)),
                -1, 1).astype(np.float32)
    jfn, jargs = JE.build_serving_fn("vae", jt.cfg, jt, state, n,
                                     mode="denoise")
    want = JE.run_artifact(_jax_artifact(jfn, jargs,
                                         str(tmp_path / "d.jaxexport")),
                           seed, inputs=x)
    eps = np.asarray(jax.random.normal(_key(seed), (n, cfg.latent_dim)))
    path = export_serving("vae", cfg, n=n, mode="denoise",
                          platforms=("cpu",),
                          artifact_path=str(tmp_path / "d.pt2"))
    got = run_artifact(path, seed, inputs=x, draws={"eps": eps},
                       device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_export_infer_cli(vae, narrow_cli, tmp_path):
    cfg = vae[0]
    art = str(tmp_path / "cli.pt2")
    assert cli.main(["export", "--family", "vae", "--out-dir",
                     cfg.run.out_dir, "--image-size", "64",
                     "--compute-dtype", "float32", "-n", "4",
                     "--platforms", "cpu", "--artifact", art]) == 0
    grid = str(tmp_path / "grid.jpg")
    assert cli.main(["infer", "--artifact", art, "--seed", "5",
                     "--out", grid, "--device", "cpu"]) == 0
    assert os.path.exists(grid)
    arr = np.load(str(tmp_path / "grid.npy"))
    np.testing.assert_array_equal(arr, run_artifact(art, 5, device="cpu"))


def test_artifact_self_contained_without_sidecar(vae, tmp_path):
    """Without the sidecar a denoise artifact is still a denoise artifact
    of n rows (read from the program's own inputs) and runs."""
    cfg = vae[0]
    path = export_serving("vae", cfg, n=2, mode="denoise",
                          platforms=("cpu",),
                          artifact_path=str(tmp_path / "bare.pt2"))
    os.remove(path + ".json")
    call, meta = load_artifact(path, device="cpu")
    assert meta["mode"] == "denoise" and meta["n"] == 2
    assert meta["family"] == "vae"
    x = np.zeros((2, 64, 64, 3), np.float32)
    out = run_artifact(path, seed=1, inputs=x, device="cpu")
    assert out.shape == x.shape and np.isfinite(out).all()
    np.testing.assert_array_equal(out, run_artifact(
        seed=1, inputs=x, loaded=(call, meta)))


def test_artifact_rejects_newer_format_version(vae, tmp_path):
    cfg = vae[0]
    path = export_serving("vae", cfg, n=2, platforms=("cpu",),
                          artifact_path=str(tmp_path / "ver.pt2"))
    side = json.load(open(path + ".json"))
    side["format_version"] = 999
    json.dump(side, open(path + ".json", "w"))
    with pytest.raises(ValueError, match="format_version"):
        load_artifact(path, device="cpu")


def test_artifact_refuses_unlisted_devices(vae, tmp_path):
    """A device the sidecar does not list is refused, and so is tpu."""
    cfg = vae[0]
    path = export_serving("vae", cfg, n=2, platforms=("cuda",),
                          artifact_path=str(tmp_path / "gpu.pt2"))
    with pytest.raises(ValueError, match="cuda"):
        load_artifact(path, device="cpu")
    with pytest.raises(ValueError, match="tpu"):
        load_artifact(path, device="tpu")
    with pytest.raises(ValueError, match="platforms"):
        export_serving("vae", cfg, n=2, platforms=("tpu", "cpu"),
                       artifact_path=str(tmp_path / "tpu.pt2"))


def test_infer_cli_single_image_npy_and_oversize_batch(vae, narrow_cli,
                                                       tmp_path, capsys):
    """A (H, W, C) .npy is a batch of one; a batch above the exported n is
    cut to n with a warning; an image file is resized to the program's
    input."""
    cfg = vae[0]
    art = str(tmp_path / "den3.pt2")
    assert cli.main(["export", "--family", "vae", "--mode", "denoise",
                     "--out-dir", cfg.run.out_dir, "--image-size", "64",
                     "--compute-dtype", "float32", "-n", "2",
                     "--platforms", "cpu", "--artifact", art]) == 0
    single = str(tmp_path / "one.npy")
    np.save(single, np.zeros((64, 64, 3), np.float32))
    out_img = str(tmp_path / "one_out.jpg")
    assert cli.main(["infer", "--artifact", art, "--input", single,
                     "--out", out_img, "--device", "cpu"]) == 0
    assert os.path.exists(out_img)
    big = str(tmp_path / "big.npy")
    np.save(big, np.zeros((5, 64, 64, 3), np.float32))
    assert cli.main(["infer", "--artifact", art, "--input", big,
                     "--out", str(tmp_path / "big_out.jpg"),
                     "--device", "cpu"]) == 0
    assert "only the first 2 rows" in capsys.readouterr().out
    from PIL import Image
    jpg = str(tmp_path / "face.jpg")
    Image.fromarray(np.full((40, 50, 3), 128, np.uint8)).save(jpg)
    assert cli.main(["infer", "--artifact", art, "--input", jpg,
                     "--out", str(tmp_path / "face_out.png"),
                     "--device", "cpu"]) == 0
    assert np.load(str(tmp_path / "face_out.npy")).shape == (2, 64, 64, 3)


def test_poly_batch_denoise_serves_any_batch_size(vae, tmp_path):
    """One poly-batch artifact serves batch 1, 3 and 7; each row equals
    the in-process denoiser on the same draws; without its sidecar it
    still says poly_batch."""
    cfg = vae[0]
    path = export_serving("vae", cfg, n=2, mode="denoise",
                          platforms=("cpu",), poly_batch=True,
                          artifact_path=str(tmp_path / "poly.pt2"))
    call, meta = load_artifact(path, device="cpu")
    assert meta["poly_batch"] is True
    trainer = _restored(cfg)
    rng = np.random.default_rng(0)
    for b in (1, 3, 7):
        x = np.clip(rng.normal(0, 0.3, (b, 64, 64, 3)), -1, 1).astype(
            np.float32)
        out = run_artifact(seed=3, inputs=x, loaded=(call, meta))
        assert out.shape == x.shape and np.isfinite(out).all()
        eps = serving_draws(meta, 3, batch=b)["eps"]
        np.testing.assert_allclose(
            out, trainer.denoise(torch.from_numpy(x), eps).numpy(),
            rtol=0, atol=1e-5)
    os.remove(path + ".json")
    _, meta2 = load_artifact(path, device="cpu")
    assert meta2["mode"] == "denoise" and meta2.get("poly_batch") is True


def test_poly_batch_rejected_for_sample_mode(vae):
    cfg = vae[0]
    with pytest.raises(ValueError, match="poly_batch"):
        build_serving_fn("vae", cfg, _restored(cfg), 2, mode="sample",
                         poly_batch=True)


def test_export_rejects_bad_mode(vae):
    cfg = vae[0]
    trainer = _restored(cfg)
    with pytest.raises(ValueError):
        build_serving_fn("gan", cfg, trainer, 2, mode="denoise")
    with pytest.raises(ValueError):
        build_serving_fn("vae", cfg, trainer, 2, mode="nope")


# ------------------------------------------------------------------ DDPM
T, HW = 8, 16


@pytest.fixture(scope="module")
def ddpm(tmp_path_factory):
    """(port config, JAX trainer, JAX state): a seeded UNet at base_ch 8,
    16x16, T=8, f32, in a port checkpoint."""
    out = tmp_path_factory.mktemp("export_ddpm")
    common = dict(timesteps=T, base_ch=8, time_emb_dim=32)
    jcfg = JC.DiffusionConfig(
        data=JC.DataConfig(image_size=(HW, HW), batch_size=2),
        run=JC.RunConfig(compute_dtype="float32"), **common)
    pcfg = PC.DiffusionConfig(
        data=PC.DataConfig(image_size=(HW, HW), batch_size=2),
        run=PC.RunConfig(out_dir=str(out), compute_dtype="float32"),
        **common)
    jt = JD.DiffusionTrainer(jcfg, (HW, HW, 3))
    params = jax_params(jt.model, np.zeros((2, HW, HW, 3), np.float32),
                        np.zeros((2,), np.int32), seed=11)
    state = JD.DiffusionState(params=params, opt_state=(),
                              step=jnp.zeros((), jnp.int32))
    pt = DiffusionTrainer(pcfg, (HW, HW, 3), device="cpu")
    load_jax_params(pt.model, params)
    L.save_checkpoint(pcfg, pt, 2)
    return pcfg, jt, state


def _ops(call):
    return [str(nd.target) for nd in call.graph.nodes
            if nd.op == "call_function"]


# the trailing optional arguments of ``vgd::groupnorm_silu``, by position
_K4_OPTIONAL = {"shift": 7, "conv_bias": 8, "residual_bias": 9}


def _k4_arg(node, name):
    """Argument ``name`` of a ``vgd::groupnorm_silu`` node (None if not
    given)."""
    i = _K4_OPTIONAL[name]
    return node.kwargs.get(name, node.args[i] if len(node.args) > i
                           else None)


@pytest.mark.parametrize("ddim_steps", [4, 0], ids=["ddim", "ancestral"])
def test_diffusion_artifact_matches_jax_run_artifact(ddpm, ddim_steps,
                                                     tmp_path):
    """DDIM (eta 0) and the ancestral chain: the JAX artifact on its
    threefry draws (xt from the first split, each step's noise from the
    chain key's splits), the port's one-step program looped over the same
    draws; the graph holds the vgd:: ops, the plain arithmetic of neither
    (atol 1e-3, module docstring)."""
    cfg, jt, state = ddpm
    seed, n = 3, 2
    jfn, jargs = JE.build_serving_fn("diffusion", jt.cfg, jt, state, n,
                                     ddim_steps=ddim_steps)
    want = JE.run_artifact(_jax_artifact(jfn, jargs,
                                         str(tmp_path / "d.jaxexport")), seed)
    k_x, k = jax.random.split(_key(seed))
    shape = (n, HW, HW, 3)
    xt = np.asarray(jax.random.normal(k_x, shape))
    noise = []
    for _ in range(T):
        k, k_noise = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_noise, shape)))
    path = export_serving("diffusion", cfg, n=n, ddim_steps=ddim_steps,
                          platforms=("cpu",),
                          artifact_path=str(tmp_path / "d.pt2"))
    call, meta = load_artifact(path, device="cpu")
    ops = _ops(call)
    assert ops.count("vgd.flash_attention.default") == 3
    assert ops.count("vgd.groupnorm_silu.default") == 14
    # gn1 of each ConvBlock takes the time projection as its shift; gn1 and
    # gn2 each take their conv's bias, and gn2 of the six blocks with a 1x1
    # residual conv that conv's bias too
    k4 = [nd for nd in call.graph.nodes
          if str(nd.target) == "vgd.groupnorm_silu.default"]
    assert {name: sum(_k4_arg(nd, name) is not None for nd in k4)
            for name in _K4_OPTIONAL} == {"shift": 7, "conv_bias": 14,
                                          "residual_bias": 6}
    # the plain forms would trace as sigmoid (GroupNorm+SiLU) and softmax
    assert not any("sigmoid" in op or "softmax" in op for op in ops)
    assert len(meta["steps"]) == (len(set(np.round(np.linspace(
        0, T - 1, ddim_steps)).astype(int))) if ddim_steps else T)
    draws = {"xt": xt} if ddim_steps else {"xt": xt, "noise": noise}
    got = run_artifact(seed, loaded=(call, meta), draws=draws)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # the port's own eager sampler on the same draws: the same ops
    tr = L.restore_trainer(cfg, device="cpu")
    eager = (tr.ddim_sample(torch.from_numpy(xt), ddim_steps, eta=0.0)
             if ddim_steps else
             tr.ancestral_sample(torch.from_numpy(xt), T - 1,
                                 noise=[torch.from_numpy(a) for a in noise]))
    np.testing.assert_array_equal(got, eager.numpy())


# ------------------------------------------------------------------ Glow
@pytest.fixture(scope="module")
def glow(tmp_path_factory):
    """(port config, JAX trainer, JAX state): a perturbed Glow (16x16,
    K=2, L=2, width 32, f32, fused_coupling) in a port checkpoint."""
    out = tmp_path_factory.mktemp("export_glow")
    common = dict(n_flows=2, n_blocks=2, filter_size=32, fused_coupling=True)
    data = dict(image_size=(HW, HW), batch_size=4, normalize=False)
    jcfg = JC.GlowConfig(data=JC.DataConfig(**data),
                         run=JC.RunConfig(compute_dtype="float32"), **common)
    pcfg = PC.GlowConfig(data=PC.DataConfig(**data),
                         run=PC.RunConfig(out_dir=str(out),
                                          compute_dtype="float32"), **common)
    jt = JGT(jcfg, (HW, HW, 3))
    state = jax.device_get(jax.jit(jt.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def perturb(path, leaf):         # every leaf but the PLU buffers
        names = {getattr(k, "key", str(k)) for k in path}
        return leaf if names & {"P", "s_sign"} else leaf + 0.1 * \
            rng.standard_normal(leaf.shape).astype(np.float32)
    state = dataclasses.replace(state, params=jax.tree_util.
                                tree_map_with_path(perturb, state.params))
    tr = GlowTrainer(pcfg, (HW, HW, 3), device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    load_jax_glow_state(tr, state)
    Checkpointer(os.path.join(out, "ckpt")).save(
        4, tr.model.state_dict(), PC.to_dict(pcfg))
    return pcfg, jt, state


def test_glow_artifact_matches_jax_run_artifact(glow, tmp_path):
    """The fused-coupling reverse: JAX's artifact (its Pallas kernels in
    interpret mode) on its threefry z, the port's program (K5's plain
    version inside the op) on the same z; one vgd::glow_coupling_fwd a
    flow in the graph."""
    cfg, jt, state = glow
    seed, n = 9, 2
    jfn, jargs = JE.build_serving_fn("glow", jt.cfg, jt, state, n)
    want = JE.run_artifact(_jax_artifact(jfn, jargs,
                                         str(tmp_path / "g.jaxexport")), seed)
    keys = jax.random.split(_key(seed), len(jt.z_shapes))
    z = np.concatenate([np.asarray(jax.random.normal(k, (n,) + s)).reshape(
        n, -1) for k, s in zip(keys, jt.z_shapes)], axis=1)
    path = export_serving("glow", cfg, n=n, platforms=("cpu",),
                          artifact_path=str(tmp_path / "g.pt2"))
    call, meta = load_artifact(path, device="cpu")
    assert _ops(call).count("vgd.glow_coupling_fwd.default") == 4
    got = run_artifact(seed, loaded=(call, meta), draws={"z": z})
    assert got.shape == (n, HW, HW, 3)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def test_artifact_loads_in_a_process_without_model_code(glow, tmp_path):
    """A process that imports only ``vgd_tpu_torch.io.export`` loads and
    runs a fused-coupling Glow artifact (its vgd:: ops registered by that
    import) after the checkpoint folder is gone, gives the same output, and
    imports no model, trainer or config module."""
    cfg = glow[0]
    path = export_serving("glow", cfg, n=2, platforms=("cpu",),
                          artifact_path=str(tmp_path / "served.pt2"))
    want = run_artifact(path, 4, device="cpu")
    moved = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, out_dir=str(tmp_path / "gone")))
    os.rename(cfg.run.out_dir, moved.run.out_dir)
    try:
        code = (
            "import sys, numpy as np\n"
            "from vgd_tpu_torch.io.export import run_artifact\n"
            f"out = run_artifact({path!r}, 4, device='cpu')\n"
            f"np.save({str(tmp_path / 'sub.npy')!r}, out)\n"
            "bad = [m for m in sys.modules if m.startswith(("
            "'vgd_tpu_torch.models', 'vgd_tpu_torch.train', "
            "'vgd_tpu_torch.core.config', 'jax'))]\n"
            "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
        subprocess.run([sys.executable, "-c", code], check=True, env=env,
                       cwd=str(tmp_path), timeout=300)
    finally:
        os.rename(moved.run.out_dir, cfg.run.out_dir)
    np.testing.assert_array_equal(np.load(str(tmp_path / "sub.npy")), want)


def _seeded(family, out):
    """A seeded port checkpoint of ``family`` at a small size on the CPU:
    (config, trainer)."""
    from vgd_tpu_torch.core.rng import seed_all
    from vgd_tpu_torch.train.gan import GANTrainer
    from vgd_tpu_torch.train.glow import GlowEEGTrainer
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    run = PC.RunConfig(out_dir=str(out), compute_dtype="float32")
    if family == "glow-eeg":
        cfg = PC.GlowEEGConfig(run=run, n_flows=2, n_blocks=2,
                               filter_size=16)
        tr = GlowEEGTrainer(cfg, device="cpu")
        ckpt, params = f"ckpt_{cfg.event_type}", None
    elif family == "vaegan":
        cfg = PC.VAEGANConfig(data=PC.DataConfig(image_size=(64, 64)),
                              run=run, latent_dim=16, ngf=8, ndf=8)
        tr = VAEGANTrainer(cfg, (64, 64, 3), device="cpu")
        ckpt = "ckpt"
    else:
        cfg = PC.GANConfig(data=PC.DataConfig(image_size=(32, 32)), run=run,
                           latent_dim=16, ngf=8, ndf=8,
                           wgan=family == "wgan")
        tr = GANTrainer(cfg, (32, 32, 3), device="cpu")
        ckpt = "ckpt"
    tr.init(seed_all(0, "cpu"))
    params = tr.model.state_dict() if family == "glow-eeg" \
        else tr.state_dict()
    Checkpointer(os.path.join(out, ckpt)).save(1, params, PC.to_dict(cfg))
    return cfg, tr


@pytest.mark.parametrize("family,mode", [
    ("vaegan", "sample"), ("vaegan", "denoise"), ("gan", "sample"),
    ("wgan", "sample"), ("glow-eeg", "sample")])
def test_every_family_exports_and_serves(family, mode, tmp_path):
    """The families the JAX package exports beyond the cases above: each
    artifact serves and equals the in-process program on its draws; a
    glow-eeg request writes its signals as .npz through ``infer``."""
    cfg, tr = _seeded(family, tmp_path / "run")
    path = export_serving(family, cfg, n=2, mode=mode, platforms=("cpu",),
                          artifact_path=str(tmp_path / "a.pt2"))
    call, meta = load_artifact(path, device="cpu")
    x = np.zeros((2, 64, 64, 3), np.float32) if mode == "denoise" else None
    out = run_artifact(seed=1, inputs=x, loaded=(call, meta))
    draws = serving_draws(meta, 1, batch=2)
    fn, _ = build_serving_fn(family, cfg, tr, 2, mode=mode)
    with torch.no_grad():
        want = fn(torch.from_numpy(x), draws["eps"]) if x is not None \
            else fn(draws["z"])
    np.testing.assert_allclose(out, want.numpy(), rtol=0, atol=1e-5)
    if family == "glow-eeg":
        assert out.shape == (2, cfg.num_samples, 1, cfg.num_channels)
        dst = str(tmp_path / "eeg")
        assert cli.main(["infer", "--artifact", path, "--out", dst,
                         "--seed", "1", "--device", "cpu"]) == 0
        np.testing.assert_array_equal(np.load(dst + ".npz")["signals"], out)
