"""The port's command line (``vgd_tpu_torch/cli.py``) against JAX's
(``vgd_tpu/cli.py``).

Both parsers are captured by patching ``argparse.ArgumentParser.parse_args``
around each ``main`` (the top-level parser is the first one parsed), and
each loop call by patching the loop functions of both ``train.loop``
modules (and ``export_serving``, ``_denoise``, ``_tstr``, ``_infer`` of
the CLIs), so nothing trains. The JAX package is not edited.
"""
from __future__ import annotations

import argparse
import dataclasses
import shlex

import numpy as np
import pytest

from vgd_tpu import cli as jax_cli
import vgd_tpu.io.export as JE
import vgd_tpu.train.loop as JL
from vgd_tpu_torch import cli
import vgd_tpu_torch.core.config as PC
import vgd_tpu_torch.io.export as PE
import vgd_tpu_torch.train.loop as L


class _Parsed(Exception):
    pass


def _parser(main):
    """The top-level parser ``main`` builds (its first ``parse_args``)."""
    seen = []
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kwargs):
        seen.append(self)
        raise _Parsed
    argparse.ArgumentParser.parse_args = grab
    try:
        main(["infer"])
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen[0]


def _commands(parser):
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


JAX_COMMANDS = _commands(_parser(jax_cli.main))
PORT_PARSER = _parser(cli.main)
PORT_COMMANDS = _commands(PORT_PARSER)
# the one deliberate difference: --device names cuda / cpu, never tpu
DEVICE = "--device"
# arguments each command requires before any other flag parses
REQUIRED = {"sample": ["--family", "glow"], "export": ["--family", "glow"],
            "denoise": ["--ckpt", "c", "--input", "i"],
            "infer": ["--artifact", "a"]}


def _jax_flags():
    return [(cmd, action.option_strings[-1])
            for cmd, p in JAX_COMMANDS.items() for action in p._actions
            if action.option_strings and action.dest != "help"]


def _action(parser, flag):
    (a,) = [a for a in parser._actions if flag in a.option_strings]
    return a


def _value(action):
    """An argv value JAX's parser takes for ``action`` (none for flags)."""
    if action.nargs == 0 or action.nargs == "?":
        return []
    if action.dest == "device":
        return ["cpu"]
    if action.choices:
        return [sorted(action.choices)[0]]
    return [{int: "3", float: "0.5"}.get(action.type, "x")]


@pytest.mark.parametrize("cmd,flag", _jax_flags())
def test_port_accepts_every_jax_flag(cmd, flag):
    """Every (command, flag) JAX's parser takes, the port's takes on the
    same command with the same kind, type, nargs and choices (--device:
    cuda / cpu, the one deliberate difference)."""
    ja = _action(JAX_COMMANDS[cmd], flag)
    pa = _action(PORT_COMMANDS[cmd], flag)
    assert (type(pa), pa.type, pa.nargs) == (type(ja), ja.type, ja.nargs)
    if flag == DEVICE:
        assert set(ja.choices) - set(pa.choices) == {"tpu"}
    else:
        assert set(pa.choices or ()) == set(ja.choices or ())
    argv = [cmd] + REQUIRED.get(cmd, []) + [flag] + _value(ja)
    JAX_COMMANDS[cmd].parse_args(argv[1:])
    PORT_PARSER.parse_args(argv)


def test_port_refuses_device_tpu():
    with pytest.raises(SystemExit):
        PORT_PARSER.parse_args(["glow", "--device", "tpu"])


# ------------------------------------------------------- loop-call parity
LOOPS = ("run_vaegan", "run_vae", "run_gan", "run_glow", "run_glow_eeg",
         "run_diffusion", "evaluate_gan_checkpoints",
         "evaluate_vae_checkpoints", "evaluate_vae_occlusion",
         "evaluate_glow_from_dir", "evaluate_diffusion_from_dir",
         "eeg_psd_and_gif", "sample_from_dir")
# config fields only JAX has: the eval_metrics switch (unread), the PRNG
# family (--prng-impl, no meaning in PyTorch) and Glow's scan unroll (no
# lax.scan); and loop arguments only one side takes: JAX's export seed (the
# port's artifact takes its seed per request), the port's device and export
# platforms (cuda where JAX names tpu). ``epoch_scan`` is compared: both
# CLIs resolve --epoch-scan / --no-epoch-scan alike
JAX_ONLY_FIELDS = {"run.eval_metrics", "run.prng_impl", "scan_unroll"}
ONE_SIDED_ARGS = {"seed", "device", "platforms"}


def _calls(monkeypatch, cli_mod, loop, export, argv):
    calls = []

    def record(name):
        return lambda *args, **kwargs: calls.append((name, args, kwargs)) \
            or {}
    for name in LOOPS:
        monkeypatch.setattr(loop, name, record(name))
    monkeypatch.setattr(loop, "load_feature_fn",
                        lambda *args, **kwargs: (None, None))
    monkeypatch.setattr(export, "export_serving", record("export_serving"))
    for name in ("_denoise", "_tstr", "_infer"):
        monkeypatch.setattr(cli_mod, name, lambda a, name=name: calls.append(
            (name, (), dict(vars(a)))))
    assert cli_mod.main(argv) == 0
    return calls


def _flat(x, prefix=""):
    if dataclasses.is_dataclass(x):
        x = dataclasses.asdict(x)
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(x) if isinstance(x, list) else x}


def _tstr_sizes(ns):
    """The port's tstr keeps unset sizes as None (the config's defaults,
    which JAX's parser spells out)."""
    eeg = PC.GlowEEGConfig()
    for jax_key, key in (("flows", "n_flows"), ("blocks", "n_blocks"),
                         ("filter_size", "filter_size")):
        v = ns.pop(key)
        ns[jax_key] = getattr(eeg, key) if v is None else v
    return ns


# JAX's documented command lines (vgd_tpu/cli.py:7-25), the port's README
# lines JAX's parser also takes (brackets expanded), and the lines JAX
# takes that the port used to refuse
LINES = [
    "vaegan --data /path/celebahq --epochs 150",
    "vae --epochs 100 --noise-std 0.5",
    "gan --epochs 150 --batch-size 128",
    "wgan --epochs 1500",
    "glow --iters 30000 --image-size 64",
    "glow-eeg --iters 6000 --event-type mi",
    "diffusion --epochs 100 --timesteps 1000 --no-attn",
    "denoise --ckpt runs/vae/ckpt --input img.jpg",
    "tstr --method synt",
    "eval-gan --out-dir runs/gan --fid",
    "eval-vae --out-dir runs/vae --occlusion",
    "eval-glow --out-dir runs/glow --fid",
    "eval-diffusion --out-dir runs/diffusion",
    "sample --family glow --out-dir runs/glow -n 16",
    "diffusion --epochs 100 --out-dir runs/diffusion --steps-per-epoch 8 "
    "--batch-size 16 --image-size 256 --lr 2e-4 --resume "
    "--profile-dir runs/diffusion/trace --keep-checkpoints 3",
    "sample --family diffusion --out-dir runs/diffusion -n 16 "
    "--ddim-steps 50",
    "eval-diffusion --out-dir runs/diffusion --max-batches 1",
    "vaegan --image-size 256 --batch-size 64 --fused-conv --out-dir "
    "runs/vaegan --epochs 150 --steps-per-epoch 9 --dataset-size 640 "
    "--compute-dtype bfloat16 --resume --profile-dir runs/vaegan/trace",
    "sample --family vaegan --out-dir runs/vaegan --image-size 256 -n 64",
    "vae --fused-conv --out-dir runs/vae --epochs 100 --noise-std 0.5 "
    "--occlusion --steps-per-epoch 9 --resume",
    "eval-vae --out-dir runs/vae --max-checkpoints 1 --max-batches 1",
    "eval-vae --out-dir runs/vae --occlusion --max-batches 1 --fid",
    "sample --family vae --out-dir runs/vae -n 64",
    "denoise --ckpt runs/vae/ckpt --input face.jpg --output restored.png",
    "gan --fused-conv --out-dir runs/gan --epochs 150",
    "wgan --fused-conv --out-dir runs/wgan",
    "eval-gan --out-dir runs/wgan --wgan --max-checkpoints 1",
    "sample --family wgan --out-dir runs/wgan -n 64",
    "glow --fused-coupling --out-dir runs/glow --iters 30000 --resume",
    "glow --fused-coupling --flow-stack --out-dir runs/glow_stack",
    "glow --fused-coupling --flow-stack 256",
    "sample --family glow --out-dir runs/glow -n 20",
    "eval-glow --out-dir runs/glow --max-batches 1 --fid "
    "--inception-weights pt_inception.pth",
    "glow-eeg --event-type mi --out-dir runs/glow_eeg --iters 6000 "
    "--eeg-path data/bci --resume",
    "eval-eeg --event-type mi --out-dir runs/glow_eeg",
    "sample --family glow-eeg --event-type mi --out-dir runs/glow_eeg -n 16",
    "tstr --method synt --ckpt-dir runs/glow_eeg --subjects 01 02",
    "export --family diffusion --out-dir runs/diffusion -n 16 "
    "--ddim-steps 50",
    "infer --artifact runs/diffusion/serving_diffusion_sample.pt2 --seed 0 "
    "--out grid.png",
    "export --family vae --mode denoise --poly-batch --out-dir runs/vae",
    "vaegan --data data/celeba --image-size 256 --fused-conv",
    "diffusion --mesh-data 8",
    "glow --pp-stages 2 --fused-coupling",
    "glow --mesh-model 2",
    "vae --multihost",
    "glow --fused-coupling --remat",
    "sample --family glow --temperature 0.5",
    "sample --family glow-eeg --temperature 0.5",
    "export --family glow --temperature 0.4",
    "glow --epochs 2 --steps-per-epoch 3",
    "eval-gan --max-batches 1",
    "tstr --iters 10",
    "diffusion --fused-conv",
    "sample --family vae --lr 1e-3 --resume",
    "eval-eeg --event-type baseline --flows 2 --batch-size 8 --lr 0.1",
    "glow-eeg --batch-size 8 --lr 0.1 --fused-conv",
    "vaegan --no-epoch-scan --fused-conv",
    "vaegan --epoch-scan",
    "diffusion --no-epoch-scan --steps-per-epoch 2",
    "diffusion --epoch-scan --no-epoch-scan",
    "vae --epoch-scan --fused-conv",
    "gan --epoch-scan --fused-conv",
    "wgan --epoch-scan --no-epoch-scan",
    "wgan --no-epoch-scan",
]


@pytest.mark.parametrize("line", LINES)
def test_both_clis_make_the_same_loop_call(monkeypatch, line):
    """Both CLIs call the same loop function with configs equal field by
    field (``JAX_ONLY_FIELDS`` aside) and the same arguments
    (``ONE_SIDED_ARGS`` aside). The WGAN's epochs are no exception:
    ``eval-gan --wgan`` and ``sample --family wgan`` keep
    ``GANConfig(wgan=True)``'s 150, and only the ``wgan`` command trains
    the reference's 1500, in both."""
    argv = shlex.split(line)
    want = _calls(monkeypatch, jax_cli, JL, JE, argv)
    got = _calls(monkeypatch, cli, L, PE, argv + ["--device", "cpu"])
    assert [c[0] for c in got] == [c[0] for c in want] and want
    for (name, jargs, jkw), (_, pargs, pkw) in zip(want, got):
        if name in ("_denoise", "_tstr", "_infer"):
            # no config in main: the namespaces' shared values
            if name == "_tstr":
                pkw = _tstr_sizes(pkw)
            shared = (set(jkw) & set(pkw)) - {"device"}
            assert {k: pkw[k] for k in shared} == {k: jkw[k] for k in shared}
            continue
        j = {f"{i}.{k}": v for i, x in enumerate(jargs)
             for k, v in _flat(x).items()}
        p = {f"{i}.{k}": v for i, x in enumerate(pargs)
             for k, v in _flat(x).items()}
        assert {k.split(".", 1)[1] for k in set(j) - set(p)} <= \
            JAX_ONLY_FIELDS
        assert set(p) <= set(j)
        assert {k: p[k] for k in p} == {k: j[k] for k in p}
        shared = (set(jkw) & set(pkw)) - ONE_SIDED_ARGS
        assert {k: pkw[k] for k in shared} == {k: jkw[k] for k in shared}
        assert set(jkw) ^ set(pkw) <= ONE_SIDED_ARGS


# a command line with flags its command ignores, and the same without them
IGNORED = [
    ("glow --epochs 5 --prng-impl rbg", "glow"),
    ("glow --steps-per-epoch 3 --epoch-scan", "glow"),
    ("glow-eeg --epochs 3 --steps-per-epoch 2 --no-epoch-scan", "glow-eeg"),
    # --epoch-scan is read by vaegan, so both lines carry it
    pytest.param("vaegan --iters 9 --epoch-scan --num-cpu-devices 4",
                 "vaegan --epoch-scan",
                 id="vaegan --iters 9 --epoch-scan --num-cpu-devices 4-"
                 "vaegan"),
    ("diffusion --iters 3 --prng-impl threefry2x32", "diffusion"),
    ("eval-gan --max-batches 1 --lr 0.1 --epochs 3 --resume", "eval-gan"),
    ("eval-glow --iters 4 --steps-per-epoch 2 --lr 0.1", "eval-glow"),
    ("sample --family vae --lr 1e-3 --resume --iters 2 --temperature 0.3",
     "sample --family vae"),
    ("sample --family diffusion --temperature 0.3 --epochs 2",
     "sample --family diffusion"),
    ("export --family gan --temperature 0.3 --lr 1e-3", "export --family gan"),
    ("eval-eeg --lr 0.1 --iters 3", "eval-eeg"),
]


@pytest.mark.parametrize("line,plain", IGNORED)
def test_ignored_flags_leave_the_call_unchanged(monkeypatch, capsys, line,
                                                plain):
    """A flag the command does not read changes nothing it is handed; the
    two with no meaning in PyTorch each say so on stderr, and the epoch
    scan's flags, read by the epoch-driven commands, never do."""
    def call(text):
        (c,) = _calls(monkeypatch, cli, L, PE,
                      shlex.split(text) + ["--device", "cpu"])
        return c[0], [_flat(x) for x in c[1]], c[2]
    assert call(line) == call(plain)
    err = capsys.readouterr().err
    for flag in cli._NO_MEANING:
        assert (f"{flag} has no meaning" in err) == (f"{flag} " in line + " ")
    assert "epoch-scan has no meaning" not in err


@pytest.mark.parametrize("line", ["tstr --iters 10",
                                  "infer --artifact a --num-cpu-devices 2"])
def test_ignored_flags_of_the_other_commands(monkeypatch, capsys, line):
    plain = " ".join(w for w in line.split()
                     if w not in ("--iters", "10", "--num-cpu-devices", "2"))
    (got,) = _calls(monkeypatch, cli, L, PE, shlex.split(line))
    (want,) = _calls(monkeypatch, cli, L, PE, shlex.split(plain))
    for ns in (got[2], want[2]):
        ns.pop("iters", None)                 # unread, as in JAX
        ns.pop("num_cpu_devices", None)
    assert got == want
    assert ("--num-cpu-devices has no meaning" in capsys.readouterr().err) \
        == ("--num-cpu-devices" in line)


# ------------------------------------------------ sample --temperature
GLOW = ["--image-size", "16", "--n-flows", "2", "--n-blocks", "2",
        "--filter-size", "16"]
EEG = ["--flows", "2", "--blocks", "2", "--filter-size", "16"]


@pytest.mark.parametrize("family", ["glow", "glow-eeg"])
def test_sample_temperature_writes_sample_from_dirs_grid(tmp_path, family):
    """``sample --family glow|glow-eeg --temperature t`` writes the grid
    ``sample_from_dir`` writes at t on the same checkpoint and seed, and
    another grid than the config's 0.7."""
    common = ["--out-dir", str(tmp_path), "--device", "cpu",
              "--compute-dtype", "float32"]
    if family == "glow":
        train = ["glow", "--batch-size", "2", "--dataset-size", "8",
                 "--iters", "1"] + GLOW
        sizes = GLOW
    else:
        train = ["glow-eeg", "--batch-size", "8", "--iters", "1"] + EEG
        sizes = ["--n-flows", "2", "--n-blocks", "2", "--filter-size", "16"]
    assert cli.main(train + common) == 0
    grids = {}
    for t in ("0.5", None):
        out = str(tmp_path / f"cli_{t}.npy")
        assert cli.main(["sample", "--family", family, "-n", "3", "--out",
                         out] + (["--temperature", t] if t else [])
                        + sizes + common) == 0
        grids[t] = np.load(out)
    if family == "glow":
        cfg = PC.GlowConfig(
            data=PC.DataConfig(batch_size=16, normalize=False,
                               image_size=(16, 16)),
            n_flows=2, n_blocks=2, filter_size=16)
    else:
        cfg = PC.GlowEEGConfig(n_flows=2, n_blocks=2, filter_size=16)
    cfg = dataclasses.replace(cfg, temperature=0.5, run=dataclasses.replace(
        cfg.run, out_dir=str(tmp_path), compute_dtype="float32"))
    ref = np.load(L.sample_from_dir(family, cfg, n=3, out_path=str(
        tmp_path / "ref.npy"), device="cpu"))
    np.testing.assert_array_equal(grids["0.5"], ref)
    assert np.isfinite(ref).all() and not np.array_equal(grids[None], ref)
