"""Every ``run_*`` loop of the port trained data-parallel on 2 gloo ranks
against the same loop in one process at the same global batch (CPU, f32,
a few layers and narrow widths), and DDPM sequence-parallel (data=1,
model=2: the bottleneck self-attention on the ring).

The ranks are fresh processes (``parallel.launch.spawn`` running
``parallel.workers.train_loops``, one torch thread each); the
one-process references run ``parallel.workers.train_loop`` in this
process. Each family runs four ways:

* ref: one process, E + 1 epochs (Glow: iterations), a checkpoint at each;
* dp: 2 ranks, E epochs from scratch;
* dp-resume: 2 ranks resuming ref's checkpoint at E, to E + 1;
* one-resume: one process resuming dp's checkpoint at E, to E + 1.

Held: the per-step global losses and every logged loss and validation
metric within 1e-5 relative; the buffers within 1e-5 (or 1e-5 of their
tensor's largest magnitude where that is larger); the parameters with the
one-device lockstep tests' bounds (``tests/test_torch_port_vaegan.py``),
both ways round after a resume. An element is real when its RMS gradient
(from the reference's Adam second moment) is at least 1e-2 of its tensor's
largest and 1e-5 of its optimizer's, and is held to 1e-4 (half of lr):
Adam's normalised update amplifies the f32 rounding of a gradient that
cancels (global BatchNorm statistics merged in another order than one
process sums them), observed up to 2.1e-5 on 3 of the VAE-GAN's 0.7 M
real elements, the rest within 1e-5. Below either threshold the update
turns the gradient's rounding into a move of up to lr a step either way
(the conv biases before a GroupNorm of one channel a group, which cancels
them exactly), so those elements are held to 2 lr a step;
the two ranks' states bit-equal after every step (``workers.fingerprint``)
and at the end; the checkpoint a 2-rank run leaves holds its final state
exactly. Sequence parallelism: the losses within 1e-4 relative, JAX's own
bound for its ring (``tests/test_tp_production.py``), and bit-equal ranks.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.parallel import workers
from vgd_tpu_torch.parallel.launch import spawn

REL, SP_REL = 1e-5, 1e-4
PARAM_ATOL = 1e-4            # real parameter elements (half of lr)
E, STEPS = 1, 2              # epochs before the resume, steps an epoch
GLOW_E = 2                   # Glow: iterations before the resume


def _run(**kw):
    return PC.RunConfig(compute_dtype="float32", **kw)


def _configs(out):
    """family -> (config, checkpoint sub-directory) at tiny sizes (a few
    layers, narrow widths); every global batch divides by 2."""
    img64 = PC.DataConfig(image_size=(64, 64), batch_size=4, dataset_size=11)
    glow_run = dict(sample_every_iters=2, checkpoint_every_iters=2)
    return {
        "diffusion": (PC.DiffusionConfig(
            data=PC.DataConfig(image_size=(16, 16), batch_size=4,
                               dataset_size=14),
            run=_run(out_dir=out), base_ch=8, time_emb_dim=32, timesteps=8),
            "ckpt"),
        "vaegan": (PC.VAEGANConfig(
            data=img64, run=_run(out_dir=out, fused_conv=True),
            latent_dim=16, ngf=8, ndf=8), "ckpt"),
        "vae": (PC.VAEConfig(
            data=dataclasses.replace(img64, noise_max_std=0.5,
                                     occlusion=True),
            run=_run(out_dir=out, fused_conv=True), latent_dim=16, ngf=8),
            "ckpt"),
        "gan": (PC.GANConfig(
            data=PC.DataConfig(image_size=(32, 32), batch_size=4,
                               dataset_size=11),
            run=_run(out_dir=out, fused_conv=True), latent_dim=16, ngf=8,
            ndf=8), "ckpt"),
        "wgan": (PC.GANConfig(
            data=PC.DataConfig(image_size=(32, 32), batch_size=4,
                               dataset_size=11),
            run=_run(out_dir=out, fused_conv=True), latent_dim=16, ngf=8,
            ndf=8, wgan=True, critic_iters=2), "ckpt"),
        "glow": (PC.GlowConfig(
            data=PC.DataConfig(image_size=(16, 16), batch_size=4,
                               dataset_size=20, normalize=False),
            run=_run(out_dir=out, **glow_run), n_flows=2, n_blocks=2,
            filter_size=16, fused_coupling=True), "ckpt"),
        "glow-eeg": (PC.GlowEEGConfig(
            run=_run(out_dir=out, **glow_run), batch_size=8, n_flows=2,
            n_blocks=2, filter_size=16), "ckpt_mi")}


FAMILIES = list(_configs("x"))


def _job(family, out, until, resume=False, **run):
    cfg, _ = _configs(str(out))[family]
    if run:
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                               **run))
    if family.startswith("glow"):
        kw = dict(n_iter=until * GLOW_E // E)
    else:
        kw = dict(epochs=until, max_steps_per_epoch=STEPS)
    return dict(family=family, cfg=cfg, resume=resume, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("loops")
    ref, one_resume, jobs = {}, {}, []
    for fam in FAMILIES:
        ref[fam] = workers.train_loop(**_job(fam, root / f"ref-{fam}", E + 1))
        # ref's checkpoint at E, for the 2 ranks to resume
        sub = _configs("x")[fam][1]
        src, dst = root / f"ref-{fam}", root / f"dpres-{fam}"
        shutil.copytree(src, dst)
        ck = Checkpointer(str(dst / sub))
        for s in ck.all_steps():
            if s > (GLOW_E if fam.startswith("glow") else E):
                os.remove(ck._path(s))
        jobs += [_job(fam, root / f"dp-{fam}", E),
                 _job(fam, dst, E + 1, resume=True)]
    jobs.append(_job("diffusion", root / "sp", E + 1,
                     mesh=PC.MeshConfig(data=1, model=2)))
    parts = spawn("vgd_tpu_torch.parallel.workers:train_loops", 2, jobs,
                  timeout=900)
    dp = {fam: [p[2 * i] for p in parts] for i, fam in enumerate(FAMILIES)}
    dpres = {fam: [p[2 * i + 1] for p in parts]
             for i, fam in enumerate(FAMILIES)}
    sp = [p[-1] for p in parts]
    for fam in FAMILIES:
        one_resume[fam] = workers.train_loop(
            **_job(fam, root / f"dp-{fam}", E + 1, resume=True))
    return dict(root=root, ref=ref, dp=dp, dpres=dpres, sp=sp,
                one_resume=one_resume)


def _losses(res):
    return [r["metrics"] for r in res["steps"]]


def _close_metrics(got, want, rel, what):
    assert len(got) == len(want) and got, what
    for g, w in zip(got, want):
        assert set(g) == set(w), what
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rel, atol=1e-7,
                                       err_msg=f"{what} {k}")


LOG_SKIP = ("images_per_sec", "trials_per_sec", "val_secs")


def _close_logs(got, want, rel, what):
    assert len(got) == len(want) and got, what
    for g, w in zip(got, want):
        for k in w:
            if k not in LOG_SKIP:
                np.testing.assert_allclose(g[k], w[k], rtol=rel, atol=1e-7,
                                           err_msg=f"{what} {k}")


def _real(payload, keys):
    """state-dict key -> (mask of the elements a real gradient moves, the
    noise bound 2 lr t) from a checkpoint's Adam state."""
    opt = payload["opt_state"]
    opts = opt if "state" not in opt else {"": opt}
    out = {}
    for name, ks in keys.items():
        st = opts[name]["state"]
        lr = opts[name]["param_groups"][0]["lr"]
        rms = {}
        for i, k in enumerate(ks):
            t = float(st[i]["step"])
            rms[k] = torch.sqrt(st[i]["exp_avg_sq"] / (1 - 0.999 ** t))
        top = max(float(r.max()) for r in rms.values())
        for i, k in enumerate(ks):
            r = rms[k]
            out[k] = ((r >= 1e-2 * r.max()) & (r > 1e-5 * top),
                      2 * lr * float(st[i]["step"]))
    return out


def _close_state(got, want, what, real=None):
    assert set(got) == set(want), what
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), (what, k)
            continue
        err = (got[k].float() - w.float()).abs()
        bound = max(REL, REL * float(w.float().abs().max()))
        if real is not None and k in real:
            mask, noise = real[k]
            assert float(err.max()) <= noise, (what, k, float(err.max()))
            err, bound = err[mask], PARAM_ATOL
        assert not err.numel() or float(err.max()) <= bound, \
            (what, k, float(err.max()))


def _ref_steps(fam):
    """Steps before the resume point."""
    return E * STEPS if not fam.startswith("glow") else GLOW_E


@pytest.mark.parametrize("fam", FAMILIES)
def test_dp_losses_match_one_process(runs, fam):
    """Every step's global losses, and every logged loss and validation
    metric, of the 2-rank run against the one-process run."""
    ref, dp = runs["ref"][fam], runs["dp"][fam]
    n = _ref_steps(fam)
    for r in dp:
        _close_metrics(_losses(r), _losses(ref)[:n], REL, fam)
        _close_logs(r["log"], ref["log"][:len(r["log"])], REL, fam)


@pytest.mark.parametrize("fam", FAMILIES)
def test_dp_ranks_stay_bit_equal(runs, fam):
    """Both ranks hold the same bits after every step and at the end, from
    scratch and after resuming."""
    for res in (runs["dp"][fam], runs["dpres"][fam]):
        a, b = res
        assert [r["fingerprint"] for r in a["steps"]] == \
            [r["fingerprint"] for r in b["steps"]]
        assert a["fingerprint"] == b["fingerprint"]
        assert all(torch.equal(a["state"][k], b["state"][k])
                   for k in a["state"])


@pytest.mark.parametrize("fam", FAMILIES)
def test_dp_state_matches_one_process(runs, fam):
    """The 2-rank run's parameters and buffers against the one-process
    run's checkpoint at the same point, and the 2-rank run's own
    checkpoint holds exactly its final state."""
    cfg_sub = _configs("x")[fam][1]
    at = GLOW_E if fam.startswith("glow") else E
    ref = Checkpointer(str(runs["root"] / f"ref-{fam}" / cfg_sub)).load(at)
    dp = runs["dp"][fam][0]
    _close_state(dp["state"], ref["params"], fam,
                 _real(ref, runs["ref"][fam]["adam_keys"]))
    saved = Checkpointer(str(runs["root"] / f"dp-{fam}" / cfg_sub)).load(
        at)
    assert all(torch.equal(saved["params"][k], v)
               for k, v in dp["state"].items())
    assert saved["opt_step"] == dp["opt_step"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_resume_across_world_sizes(runs, fam):
    """One process resumes the 2-rank checkpoint, and 2 ranks resume the
    one-process checkpoint: each continues as the one-process run did
    (steps after the resume, final state)."""
    ref = runs["ref"][fam]
    n = _ref_steps(fam)
    cfg_sub = _configs("x")[fam][1]
    real = _real(Checkpointer(str(runs["root"] / f"ref-{fam}" /
                                  cfg_sub)).load(), ref["adam_keys"])
    for what, res in (("one-resume", runs["one_resume"][fam]),
                      ("dp-resume", runs["dpres"][fam][0])):
        _close_metrics(_losses(res), _losses(ref)[n:], REL, f"{fam} {what}")
        _close_state(res["state"], ref["state"], f"{fam} {what}", real)
        assert res["opt_step"] == ref["opt_step"]


def test_sequence_parallel_diffusion_matches_one_process(runs):
    """run_diffusion with data=1, model=2 (both ranks hold the global
    batch; the bottleneck tokens ride the ring): per-step losses and the
    logged train / validation losses within 1e-4 of the one-process run,
    and both ranks bit-equal after every step."""
    ref = runs["ref"]["diffusion"]
    a, b = runs["sp"]
    for r in (a, b):
        _close_metrics(_losses(r), _losses(ref), SP_REL, "sp")
        _close_logs(r["log"], ref["log"], SP_REL, "sp")
    assert [r["fingerprint"] for r in a["steps"]] == \
        [r["fingerprint"] for r in b["steps"]]
    assert a["fingerprint"] == b["fingerprint"]
