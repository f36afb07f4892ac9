"""Port EEG workflow against the JAX package, on the CPU in f32.

* ``data/eeg.py``: synthetic trials and sessions bit-equal, ``extract_trials``
  on a small recording written to disk (truncated and non-finite windows
  among its events), the batch stream's order with ``skip``;
* ``GlowEEGTrainer`` at 4 channels x 16 samples, K=2, L=2, width 16: the
  ActNorm init and three train steps in lockstep with JAX's trainer, each
  from JAX's state before it (weights and Adam over
  ``io.jax_params.load_jax_glow_state``), the dequantisation noise rebuilt
  from JAX's key; ``reverse`` of the same z; ``sample_z``'s shapes;
* ``eval/eeg_downstream.py``: bandpass, CSP filters and the central PSD
  within 1e-12 of JAX's; the numpy LDA's predictions equal to sklearn's and
  the TSTR scores of all four regimes within 1e-12 of JAX's (which uses
  sklearn), on the synthetic sessions; no sklearn import in the port;
* ``run_glow_eeg`` resumes exactly, the CLI chain ``glow-eeg`` (both event
  types) -> ``eval-eeg`` -> ``sample --family glow-eeg`` -> ``tstr`` runs at
  a tiny depth on the synthetic 22 x 160 trials, and the entry points
  refuse to run without a card unless asked for the CPU.
"""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.data import eeg as JE
from vgd_tpu.eval import eeg_downstream as JD
from vgd_tpu.train.glow import GlowEEGTrainer as JT
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.data import eeg as PE
from vgd_tpu_torch.eval import eeg_downstream as PD
from vgd_tpu_torch.io.jax_params import (_adam_leaves, _flatten,
                                         from_jax_glow_params,
                                         load_jax_glow_state)
from vgd_tpu_torch.models.glow import calc_z_shapes_eeg
from vgd_tpu_torch.ops import kernels as K
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.train.glow import GlowEEGTrainer as PT

ROOT = Path(__file__).resolve().parents[1]
B, C, T, FLOWS, BLOCKS, F, LR, STEPS = 4, 4, 16, 2, 2, 16, 1e-3, 3
# f32 forwards of the same math in other summation orders: the loss within
# 1e-5 relative; the reverse within 1e-4 of the largest |value|
LOSS_RTOL, REV_REL = 1e-5, 1e-4
# one step from the same state (the image Glow lockstep's bounds): elements
# with a real gradient (>= 1e-2 of their tensor's largest and 1e-5 of the
# model's) within 1e-6; every element within 2 lr (Adam's first updates
# move an element by about lr whatever its gradient's size, so f32 noise of
# a near-zero gradient can move it by up to 2 lr); Adam moments within 1e-3
# of their tensor's max plus 1e-5 of the model's largest moment
PARAM_ATOL, NOISE_PARAM_ATOL = 1e-6, 2 * LR
REAL_GRAD_TENSOR, REAL_GRAD_NET = 1e-2, 1e-5
MOM_REL, MOM_FLOOR = 1e-3, 1e-5
# host numpy / scipy on both sides: the same calls, so equal up to 1e-12
HOST_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("event", ["mi", "baseline"])
def test_synthetic_trials_and_sessions_bit_equal(event):
    np.testing.assert_array_equal(PE.synthetic_trials(5, event, seed=3),
                                  JE.synthetic_trials(5, event, seed=3))
    for session in ("T", "E"):
        for subject in (None, "02"):
            got = PE.EEGDataset(None, session, event, subject,
                                synthetic_n=12)
            want = JE.EEGDataset(None, session, event, subject,
                                 synthetic_n=12)
            np.testing.assert_array_equal(got.as_ncT(), want.as_ncT())
            np.testing.assert_array_equal(got.as_nhwc(), want.as_nhwc())
    assert PE.OVERLAP_SIGMA == JE.OVERLAP_SIGMA
    assert PE.CHANNEL_NAMES == JE.CHANNEL_NAMES


def _recording(rng, n=3000):
    """One recording: 25 channels (the first 22 kept), events of every cue,
    one window cut short by the end, one window with a NaN in it."""
    s = rng.standard_normal((n, 25)).astype(np.float64)
    events = [(768, 10), (769, 100), (770, 800), (768, 900), (771, 1500),
              (783, 1600), (772, 2500), (768, 2600), (7, 50)]
    s[1560, 3] = np.nan                  # inside the 1500 window
    etyp = np.array([[e] for e, _ in events])
    epos = np.array([[p] for _, p in events])
    return {"s": s, "etyp": etyp, "epos": epos}


def test_extract_trials_and_recordings_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i, subject in enumerate(("01", "02")):
        for session in ("T", "E"):
            np.savez(tmp_path / f"A{subject}{session}.npz",
                     **_recording(rng, 2800 + 200 * i))
    rec = _recording(np.random.default_rng(1))
    for event in ("mi", "baseline"):
        got = PE.extract_trials(rec, event)
        want = JE.extract_trials(rec, event)
        assert len(got) == len(want) == {"mi": 3, "baseline": 2}[event]
        for a, b in zip(got, want):
            assert a.shape == (22, 160)
            np.testing.assert_array_equal(a, b)
        for subject in (None, "02"):
            np.testing.assert_array_equal(
                PE.EEGDataset(str(tmp_path), "T", event, subject).as_ncT(),
                JE.EEGDataset(str(tmp_path), "T", event, subject).as_ncT())


@pytest.mark.parametrize("skip", [0, 3, 25])
def test_batch_stream_matches_jax(skip):
    ds_p = PE.EEGDataset(None, "T", "mi", synthetic_n=40)
    ds_j = JE.EEGDataset(None, "T", "mi", synthetic_n=40)
    got = PE.eeg_batches(ds_p, 8, seed=5, skip=skip)
    want = JE.eeg_batches(ds_j, 8, seed=5, skip=skip)
    for _ in range(12):           # 5 batches a pass: crosses passes
        np.testing.assert_array_equal(next(got), next(want))


# -- the trainer -------------------------------------------------------------

def _cfgs():
    common = dict(num_channels=C, num_samples=T, batch_size=B,
                  n_flows=FLOWS, n_blocks=BLOCKS, filter_size=F, lr=LR)
    return JC.GlowEEGConfig(**common), PC.GlowEEGConfig(**common)


def _draws(i):
    """Step i's float batch (B, T, 1, C), its key and JAX's U(0, 1) noise."""
    batch = (3 * np.random.default_rng(300 + i).standard_normal(
        (B, T, 1, C))).astype(np.float32)
    key = jax.random.PRNGKey(300 + i)
    return batch, key, np.array(jax.random.uniform(key, batch.shape))


def _perturbed(params, seed=0, noise=0.1):
    """Every trainable leaf but P / s_sign perturbed, so the ZeroConvs are
    non-zero and every gradient is real."""
    rng = np.random.default_rng(seed)
    leaves = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [getattr(k, "key", str(k)) for k in path]
        if not {"P", "s_sign"} & set(names):
            leaf = leaf + noise * rng.standard_normal(leaf.shape).astype(
                np.float32)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), leaves)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's states before and after the ActNorm init and each of STEPS
    train steps, each step's metrics, and a reverse of fixed z."""
    jc, pc = _cfgs()
    jt = JT(jc)
    st = jt._make_state(_perturbed(jt.init(jax.random.PRNGKey(0)).params))
    states = [jax.device_get(st)]
    batch, key, _ = _draws(-1)
    st = jt.init_step(st, jnp.asarray(batch), key)
    states.append(jax.device_get(st))
    metrics = []
    for i in range(STEPS):
        batch, key, _ = _draws(i)
        st, m = jt.train_step(st, jnp.asarray(batch), key)
        states.append(jax.device_get(st))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    rng = np.random.default_rng(9)
    z = [(0.7 * rng.standard_normal((3,) + s)).astype(np.float32)
         for s in jt.z_shapes]
    rev = np.asarray(jt.reverse(st, [jnp.asarray(a) for a in z]))
    return pc, states, metrics, z, rev, jt.z_shapes


def _port(pc, state):
    tr = PT(pc, device="cpu")
    tr.init(torch.Generator().manual_seed(0))
    return load_jax_glow_state(tr, state)


def _close(got, want, rel, err_msg=""):
    got, want = np.asarray(got.detach()), np.asarray(want)
    assert got.shape == want.shape, err_msg
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err_msg, err)


def test_init_step_matches_jax(jax_run):
    """ActNorm's init from the perturbed JAX state: every parameter within
    1e-5 of its largest value, Adam fresh, no kernel launched."""
    pc, states, _, _, _, _ = jax_run
    tr = _port(pc, states[0])
    batch, _, noise = _draws(-1)
    K.LAUNCHES.clear()
    tr.init_step(torch.from_numpy(batch), noise=torch.from_numpy(noise))
    assert not tr.opt.state_dict()["state"] and not sum(K.LAUNCHES.values())
    want = from_jax_glow_params(_np(states[1].params), tr.model)
    for k, p in tr.model.state_dict().items():
        _close(p, want[k], 1e-5, k)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_from_jax_state_matches_jax(jax_run, step):
    """One port step from JAX's state before step ``step``: loss, log_p,
    logdet (the reference's calc_loss(T, 1, n_channels=3)), every parameter
    and Adam moment after it (bounds at the top of the file)."""
    pc, states, metrics, _, _, _ = jax_run
    before, after = states[step + 1], states[step + 2]
    tr = _port(pc, before)
    batch, _, noise = _draws(step)
    K.LAUNCHES.clear()
    m = tr.train_step(torch.from_numpy(batch), noise=torch.from_numpy(noise))
    assert not sum(K.LAUNCHES.values())
    assert set(m) == set(metrics[step])
    for k, v in m.items():
        np.testing.assert_allclose(float(v), metrics[step][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    assert tr.step == int(after.step)
    model = tr.model
    want = from_jax_glow_params(_np(after.params), model)
    _, mu, nu = _adam_leaves(after.opt_state)
    _, mu0, _ = _adam_leaves(before.opt_state)
    mu, nu, mu0 = (_flatten(_np(t)) for t in (mu, nu, mu0))
    grads = {k: (mu[k] - 0.9 * mu0[k]) / 0.1 for k in mu}
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    state = tr.opt.state_dict()["state"]
    for key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
        top = max(float(np.abs(v).max()) for v in ref.values())
        for j, (k, _) in enumerate(model.named_parameters()):
            err = float(np.abs(state[j][key].numpy() - ref[k]).max())
            assert err <= MOM_REL * float(np.abs(ref[k]).max()) + \
                MOM_FLOOR * top, (k, key, err)
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k].numpy())
        g = np.abs(grads[k])
        real = (g >= REAL_GRAD_TENSOR * g.max()) & (g > REAL_GRAD_NET * gmax)
        assert not real.any() or diff[real].max() <= PARAM_ATOL, \
            (k, float(diff[real].max()))
        assert diff.max() <= NOISE_PARAM_ATOL, (k, float(diff.max()))


def test_reverse_and_sample_z_match_jax(jax_run):
    pc, states, _, z, rev, z_shapes = jax_run
    tr = _port(pc, states[-1])
    _close(tr.reverse([torch.from_numpy(a) for a in z]), rev, REV_REL)
    got = tr.sample_z(torch.Generator().manual_seed(1), 5)
    assert [tuple(t.shape[1:]) for t in got] == list(z_shapes) == \
        calc_z_shapes_eeg(C, T, BLOCKS)
    assert all(t.shape[0] == 5 for t in got)
    assert tr.model.variant == "eeg" and not tr.model.fused_coupling \
        and tr.model.flow_stack is False


# -- downstream evaluation ---------------------------------------------------

def _session(mod, kind, subject="01"):
    mi = mod.EEGDataset(None, kind, "mi", subject).as_ncT()
    bl = mod.EEGDataset(None, kind, "baseline", subject).as_ncT()
    return (np.concatenate([mi, bl]).astype(np.float64),
            np.concatenate([np.ones(len(mi)), np.zeros(len(bl))]))


@pytest.fixture(scope="module")
def sessions():
    x_te, y_te = _session(PE, "E")
    x_tr, y_tr = _session(PE, "T")
    x_o, y_o = _session(PE, "T", "02")
    # stand-ins for generated trials: synthetic trials of other seeds
    x_g = np.concatenate([PE.synthetic_trials(48, "mi", seed=5),
                          PE.synthetic_trials(48, "baseline", seed=6)])
    y_g = np.concatenate([np.ones(48), np.zeros(48)])
    train = {"synt": (x_g, y_g), "real": (x_tr, y_tr),
             "sr": (np.concatenate([x_g, x_tr]), np.concatenate([y_g, y_tr])),
             "other_sub": (x_o, y_o)}
    return train, (x_te, y_te)


def test_filters_csp_and_psd_match_jax(sessions):
    train, _ = sessions
    x, y = train["real"]
    fp, fj = PD.bandpass_filter(x), JD.bandpass_filter(x)
    np.testing.assert_allclose(fp, fj, rtol=0, atol=HOST_TOL)
    np.testing.assert_allclose(PD.CSP().fit(fp, y).filters_,
                               JD.CSP().fit(fj, y).filters_, rtol=0,
                               atol=HOST_TOL)
    for a, b in zip(PD.mean_central_psd(x.astype(np.float32)),
                    JD.mean_central_psd(x.astype(np.float32))):
        np.testing.assert_allclose(a, b, rtol=HOST_TOL, atol=0)


@pytest.mark.parametrize("method", ["synt", "real", "sr", "other_sub"])
def test_tstr_matches_sklearn_lda(sessions, method):
    """The numpy LDA predicts exactly what sklearn's predicts, and the
    train / test scores equal JAX's ``tstr_evaluate`` (sklearn inside)."""
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis
    train, (x_te, y_te) = sessions
    x_tr, y_tr = train[method]
    got = PD.tstr_evaluate(x_tr, y_tr, x_te, y_te)
    want = JD.tstr_evaluate(x_tr, y_tr, x_te, y_te)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"acc", "f1", "k"}
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=HOST_TOL)
    csp = PD.CSP().fit(PD.bandpass_filter(x_tr), y_tr)
    f_tr = csp.transform(PD.bandpass_filter(x_tr))
    f_te = csp.transform(PD.bandpass_filter(x_te))
    ours, ref = PD.LDA().fit(f_tr, y_tr), \
        LinearDiscriminantAnalysis().fit(f_tr, y_tr)
    for f in (f_tr, f_te):
        np.testing.assert_array_equal(ours.predict(f), ref.predict(f))
    if method == "real":       # the synthetic data's tuned ~0.83
        assert 0.5 < got[1]["acc"] < 1.0


def test_classification_scores_edge_cases_match_sklearn():
    from sklearn.metrics import accuracy_score, cohen_kappa_score, f1_score
    for yt, yp in (([1, 0, 1, 1], [1, 1, 0, 1]), ([0, 0, 0], [0, 0, 0]),
                   ([1, 1, 0], [0, 0, 0]), ([1.0, 0.0], [1.0, 0.0])):
        got = PD.classification_scores(yt, yp)
        np.testing.assert_allclose(
            [got["acc"], got["f1"], got["k"]],
            [accuracy_score(yt, yp), f1_score(yt, yp, zero_division=0.0),
             cohen_kappa_score(yt, yp)], rtol=0, atol=HOST_TOL)


def test_port_imports_no_sklearn():
    bad = []
    for f in sorted((ROOT / "vgd_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [f"{f.name}: {n}" for n in names
                    if n.split(".")[0] == "sklearn"]
    assert not bad, bad


# -- the loop and the CLI ----------------------------------------------------

def _run_cfg(out_dir, event="mi"):
    return PC.GlowEEGConfig(
        run=PC.RunConfig(out_dir=str(out_dir), compute_dtype="float32",
                         sample_every_iters=2, checkpoint_every_iters=2),
        batch_size=8, n_flows=FLOWS, n_blocks=BLOCKS, filter_size=F,
        event_type=event)


def test_run_glow_eeg_resume_is_exact(tmp_path):
    """4 iterations straight equal 2 plus a resumed 2: parameters and
    buffers, Adam, the log, the sample dumps (N, C, T); the checkpoint dir
    is ckpt_<event>; the PSD arrays are written."""
    straight = L.run_glow_eeg(_run_cfg(tmp_path / "a"), n_iter=4,
                              device="cpu")
    L.run_glow_eeg(_run_cfg(tmp_path / "b"), n_iter=2, device="cpu")
    resumed = L.run_glow_eeg(_run_cfg(tmp_path / "b"), n_iter=4, resume=True,
                             device="cpu")
    ta, tb = straight["trainer"], resumed["trainer"]
    assert ta.step == tb.step == 4
    sa, sb = ta.model.state_dict(), tb.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = ta.opt.state_dict()["state"], tb.opt.state_dict()["state"]
    for i in oa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][key], ob[i][key]), (i, key)

    def rows(path):
        return [{k: v for k, v in json.loads(x).items()
                 if k != "trials_per_sec"} for x in
                (path / "eeg_mi.jsonl").read_text().splitlines()]
    assert rows(tmp_path / "a") == rows(tmp_path / "b")
    assert [r["iter"] for r in rows(tmp_path / "a")] == [2, 4]
    dump = np.load(tmp_path / "a" / "sample" / "fake_eeg_mi_training_4.npz")
    arr = dump[dump.files[0]]
    assert arr.shape == (16, 22, 160) and np.isfinite(arr).all()
    np.testing.assert_array_equal(
        np.load(tmp_path / "b" / "sample" / "fake_eeg_mi_training_4.npz")[
            dump.files[0]], arr)
    ckpt = torch.load(tmp_path / "a" / "ckpt_mi" / "00000004.pt",
                      weights_only=True)
    assert ckpt["step"] == 4 and ckpt["opt_step"] == 4
    psd = np.load(tmp_path / "a" / "psd_mi.npz")
    assert psd["real"].shape == psd["fake"].shape == psd["freq"].shape
    assert int(psd["n_real"]) == 288


def test_cli_eeg_chain(tmp_path, capsys):
    sizes = ["--flows", "2", "--blocks", "2", "--filter-size", "16"]
    common = ["--out-dir", str(tmp_path), "--device", "cpu",
              "--compute-dtype", "float32"]
    with pytest.raises(SystemExit, match="no checkpoint exists"):
        cli.main(["tstr", "--method", "synt", "--ckpt-dir", str(tmp_path),
                  "--device", "cpu"] + sizes)
    for event in ("mi", "baseline"):
        assert cli.main(["glow-eeg", "--iters", "2", "--batch-size", "8",
                         "--event-type", event]
                        + sizes + common) == 0
        # the run ends with its PSD comparison and a final checkpoint
        assert f"psd_{event}.npz" in capsys.readouterr().out
        assert (tmp_path / f"ckpt_{event}" / "00000002.pt").exists()
    assert cli.main(["eval-eeg", "--n-fake", "8"] + sizes + common) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert Path(res["psd_npz"]).exists()
    assert cli.main(["sample", "--family", "glow-eeg", "-n", "3",
                     "--event-type", "baseline", "--n-flows", "2",
                     "--n-blocks", "2", "--filter-size", "16"] + common) == 0
    trials = np.load(tmp_path / "glow-eeg_samples.npy")
    assert trials.shape == (3, 22, 160) and np.isfinite(trials).all()
    for method in ("synt", "real", "sr", "other_sub"):
        assert cli.main(["tstr", "--method", method, "--ckpt-dir",
                         str(tmp_path), "--subjects", "01", "02",
                         "--n-samples", "24", "--device", "cpu"]
                        + sizes) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(res) == {"01", "02"}
        for scores in res.values():
            assert all(0.0 <= scores[s]["acc"] <= 1.0
                       for s in ("train", "test"))


def test_eeg_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _run_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.run_glow_eeg(cfg, n_iter=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.eeg_psd_and_gif(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.sample_from_dir("glow-eeg", cfg, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["glow-eeg", "--iters", "1", "--out-dir", str(tmp_path)])
