"""Port data, configs, image ops, metrics and checkpoints against the JAX
package (CPU)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgd_tpu.core import config as JC
from vgd_tpu.data import celeba as JDATA
from vgd_tpu.eval import metrics as JM
from vgd_tpu.ops import image as JI
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.data import celeba as PDATA
from vgd_tpu_torch.eval import metrics as PM
from vgd_tpu_torch.io.checkpoint import Checkpointer
from vgd_tpu_torch.ops import image as PI


def test_synthetic_faces_byte_equal():
    for size, seed in (((16, 16), 0), ((32, 24), 7)):
        np.testing.assert_array_equal(
            PDATA.synthetic_faces(5, size, 3, seed=seed),
            JDATA.synthetic_faces(5, size, 3, seed=seed))


@pytest.mark.parametrize("name", ["DataConfig", "RunConfig",
                                  "DiffusionConfig", "VAEGANConfig",
                                  "GlowConfig", "GlowEEGConfig", "VAEConfig",
                                  "GANConfig"])
def test_config_defaults_equal_jax(name):
    """Every field the port keeps has the JAX package's default."""
    port, ref = getattr(PC, name)(), getattr(JC, name)()
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if dataclasses.is_dataclass(got):
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), \
                    f"{name}.{f.name}.{g.name}"
        else:
            assert got == want, f"{name}.{f.name}"


def test_loaders_match_jax():
    """Same split, same shuffled train batches, same padded val batch."""
    cfg_j = JC.DataConfig(image_size=(8, 8), batch_size=4, dataset_size=22)
    cfg_p = PC.DataConfig(image_size=(8, 8), batch_size=4, dataset_size=22)
    tj, vj, shape_j = JDATA.make_image_datasets(cfg_j, seed=3)
    tp, vp, shape_p = PDATA.make_image_datasets(cfg_p, seed=3)
    assert shape_p == shape_j and len(tp) == len(tj) and len(vp) == len(vj)
    for _ in range(2):      # two epochs: the shuffle follows the epoch
        for (bj, nj), (bp, np_) in zip(tj.epoch(), tp.epoch()):
            np.testing.assert_array_equal(bp, bj)
            assert nj == np_
    got = list(vp.epoch())
    want = list(vj.epoch())
    assert [n for _, n in got] == [n for _, n in want]
    for (bp, _), (bj, _) in zip(got, want):
        np.testing.assert_array_equal(bp, bj)


def test_image_folder_not_ported_yet(tmp_path, capsys):
    """A path that is not a folder falls back to synthetic faces, as in the
    JAX package (the folder decode itself: tests/test_torch_port_io.py)."""
    missing = str(tmp_path / "faces")
    cfg_p = PC.DataConfig(path=missing, image_size=(8, 8), batch_size=4,
                          dataset_size=10)
    cfg_j = JC.DataConfig(path=missing, image_size=(8, 8), batch_size=4,
                          dataset_size=10)
    tp, _, shape = PDATA.make_image_datasets(cfg_p, seed=2)
    tj, _, _ = JDATA.make_image_datasets(cfg_j, seed=2)
    assert shape == (8, 8, 3)
    np.testing.assert_array_equal(tp.ds.array, tj.ds.array)
    assert f"{missing} is not a folder" in capsys.readouterr().out


def test_image_ops_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 4, 4, 3), dtype=np.uint8)
    np.testing.assert_allclose(PI.to_signed(torch.from_numpy(u8)).numpy(),
                               np.asarray(JI.to_signed(jnp.asarray(u8))),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(PI.to_unit(torch.from_numpy(u8)).numpy(),
                               np.asarray(JI.to_unit(jnp.asarray(u8))),
                               rtol=0, atol=1e-7)
    x = rng.uniform(-1.2, 1.2, (3, 4, 4, 3)).astype(np.float32)
    unit = PI.signed_to_unit(torch.from_numpy(x))
    np.testing.assert_allclose(unit.numpy(),
                               np.asarray(JI.signed_to_unit(jnp.asarray(x))),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        PI.unit_to_uint8(unit).numpy(),
        np.asarray(JI.unit_to_uint8(JI.signed_to_unit(jnp.asarray(x)))))
    a = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(PM.psnr(ta, tb)),
                               float(JM.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(PM.mse_metric(ta, tb)),
        float(JM.mse_metric(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


def test_checkpoint_round_trip_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"), keep=2)
    cfg = PC.DiffusionConfig(timesteps=8)
    for step in (1, 2, 3):
        ck.save(step, {"w": torch.full((2,), float(step))}, PC.to_dict(cfg))
    assert ck.all_steps() == [2, 3]
    params, step, conf = ck.restore()
    assert step == 3 and torch.equal(params["w"], torch.full((2,), 3.0))
    assert conf == PC.to_dict(cfg)
    assert ck.restore(2)[1] == 2
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()
