"""The port's IO and data path on the CPU against the JAX package: the JPEG
folder decode and its uint8 memmap cache (byte-equal, and each package
opens the other's cache), the reference-checkpoint importers (the same
trees as ``vgd_tpu.io.torch_import``, loaded through the weight bridge into
the port's modules, which then compute what the reference's torch modules
compute), the artifact writers and ``--debug-nans``."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_parity import (_randomize, _torch_discriminator_64,
                               _torch_generator_64, _TorchEncoder)
from vgd_tpu.data import celeba as JDATA
from vgd_tpu.io import torch_import as JTI
from vgd_tpu_torch import cli
from vgd_tpu_torch.core import config as PC
from vgd_tpu_torch.data import celeba as PDATA
from vgd_tpu_torch.io import artifacts as PA
from vgd_tpu_torch.io import torch_import as PTI
from vgd_tpu_torch.models.gan import Discriminator, Generator
from vgd_tpu_torch.models.glow import Glow
from vgd_tpu_torch.models.unet import UNet
from vgd_tpu_torch.models.vae import Encoder
from vgd_tpu_torch.train.diffusion import DiffusionTrainer

# CelebA's aligned crops (178 x 218), a landscape and a small square: the
# short side resized and the centre cropped, both ways round
JPEG_SIZES = [(178, 218), (218, 178), (40, 40), (100, 60), (64, 81)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two torch threads: the suite runs several test files at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jpegs(folder, sizes=JPEG_SIZES):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(folder, f"{i:03d}.jpg"),
                                  quality=90)
    return str(folder)


@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
def test_decode_folder_byte_equal_to_jax(tmp_path, size):
    """Two copies of one folder: each package decodes its own copy; the
    arrays (and the cache files) are byte-equal."""
    a = _jpegs(tmp_path / "a")
    b = _jpegs(tmp_path / "b")
    got = PDATA._decode_folder(a, size, None)
    want = JDATA._decode_folder(b, size, None, progress=False)
    assert got.shape == (len(JPEG_SIZES),) + size + (3,)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    name = os.path.basename(PDATA.cache_path(a, size, len(JPEG_SIZES)))
    assert name.startswith(f".vgd_cache_{size[0]}x{size[1]}_")
    with open(os.path.join(a, name), "rb") as fa, \
            open(PDATA.cache_path(b, size, len(JPEG_SIZES)), "rb") as fb:
        assert fa.read()[128:] == fb.read()[128:]   # past the .npy header


def _no_decode(*_):
    raise AssertionError("decoded although a cache exists")


def test_each_package_opens_the_others_cache(tmp_path, monkeypatch):
    folder = _jpegs(tmp_path / "faces")
    first = np.asarray(JDATA._decode_folder(folder, (16, 16), 4,
                                            progress=False))
    monkeypatch.setattr(PDATA, "_decode_one", _no_decode)
    np.testing.assert_array_equal(
        np.asarray(PDATA._decode_folder(folder, (16, 16), 4)), first)
    # and the other way round, at another size (another cache file)
    monkeypatch.undo()
    first = np.asarray(PDATA._decode_folder(folder, (8, 16), None))
    monkeypatch.setattr(JDATA, "_decode_one", _no_decode)
    np.testing.assert_array_equal(
        np.asarray(JDATA._decode_folder(folder, (8, 16), None,
                                        progress=False)), first)


def test_make_image_datasets_reads_the_folder(tmp_path, capsys):
    """A folder: the loaders serve the decoded bytes (the JAX package's
    split and order) and the [data] line names the folder and its cache
    (a missing folder: tests/test_torch_port_data.py)."""
    folder = _jpegs(tmp_path / "faces", JPEG_SIZES * 2)
    cfg = PC.DataConfig(path=folder, image_size=(16, 16), batch_size=2)
    train, val, shape = PDATA.make_image_datasets(cfg, seed=1)
    out = capsys.readouterr().out
    assert f"10 images 16x16 from {folder}" in out and ".vgd_cache_" in out
    jtrain, jval, _ = JDATA.make_image_datasets(
        JDATA.DataConfig(path=folder, image_size=(16, 16), batch_size=2),
        seed=1)
    assert shape == (16, 16, 3)
    for (bp, _), (bj, _) in zip(train.epoch(), jtrain.epoch()):
        np.testing.assert_array_equal(bp, bj)


# ------------------------------------------------------------ importers
def _same_tree(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def _nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def test_import_generator_and_discriminator(tmp_path):
    """The reference DCGAN at 64x64 (gan_code.py, as
    tests/test_torch_parity.py builds it): the port's trees equal JAX's,
    and the bridged port modules compute the torch modules' outputs in
    eval mode (atol 2e-4, as the JAX parity test); a ``module.`` prefix is
    stripped."""
    tg, td = _torch_generator_64(), _torch_discriminator_64()
    _randomize(tg, seed=3)
    _randomize(td, seed=4)
    tg.eval()
    td.eval()
    gp, dp = str(tmp_path / "g.pth"), str(tmp_path / "d_dp.pth")
    torch.save(tg.state_dict(), gp)
    torch.save({f"module.{k}": v for k, v in td.state_dict().items()}, dp)
    gv = PTI.import_generator(gp, n_up=4)
    dv = PTI.import_discriminator(dp, n_down=4)
    _same_tree(gv, JTI.import_generator(gp, n_up=4))
    _same_tree(dv, JTI.import_discriminator(dp, n_down=4))
    gen = PTI.load_into(Generator(img_size=64, nz=100, ngf=64), gv).eval()
    disc = PTI.load_into(Discriminator(img_size=64, ndf=64), dv).eval()
    z = np.random.default_rng(0).standard_normal((2, 100, 1, 1)).astype(
        np.float32)
    x = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        torch.testing.assert_close(gen(_nhwc(z), train=False),
                                   _nhwc(tg(torch.from_numpy(z)).numpy()),
                                   atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(disc(_nhwc(x), train=False),
                                   td(torch.from_numpy(x)).view(-1),
                                   atol=2e-4, rtol=2e-4)


def test_import_encoder(tmp_path):
    te = _TorchEncoder()
    _randomize(te, seed=2)
    te.eval()
    path = str(tmp_path / "enc.pth")
    torch.save(te.state_dict(), path)
    ev = PTI.import_encoder(path)
    _same_tree(ev, JTI.import_encoder(path))
    enc = PTI.load_into(Encoder(64, latent_dim=100), ev).eval()
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    with torch.no_grad():
        mu, lv = enc(_nhwc(x), train=False)
        mu_t, lv_t = te(torch.from_numpy(x))
    torch.testing.assert_close(mu, mu_t, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(lv, lv_t, atol=2e-4, rtol=2e-4)


def _unet_state_dict(base, ted, g):
    """A reference-layout DDPM UNet state_dict (diffusion_model.py) of
    random values at base width ``base``."""
    sd = {}

    def lin(name, i, o):
        sd[f"{name}.weight"] = torch.randn(o, i, generator=g) * 0.05
        sd[f"{name}.bias"] = torch.randn(o, generator=g) * 0.05

    def conv(name, i, o, k):
        sd[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g) * 0.05
        sd[f"{name}.bias"] = torch.randn(o, generator=g) * 0.05

    def gn(name, c):
        sd[f"{name}.weight"] = 1 + torch.randn(c, generator=g) * 0.05
        sd[f"{name}.bias"] = torch.randn(c, generator=g) * 0.05

    lin("time_mlp.0", ted, 4 * ted)
    lin("time_mlp.2", 4 * ted, ted)
    c = base
    dims = {"down1": (3, c), "down2": (c, 2 * c), "down3": (2 * c, 4 * c),
            "bottleneck": (4 * c, 4 * c), "up3": (8 * c, 2 * c),
            "up2": (4 * c, c), "up1": (2 * c, c)}
    for name, (i, o) in dims.items():
        conv(f"{name}.conv.0", i, o, 3)
        gn(f"{name}.conv.1", o)
        conv(f"{name}.conv.3", o, o, 3)
        gn(f"{name}.conv.4", o)
        lin(f"{name}.time_emb_proj", ted, o)
        if i != o:
            conv(f"{name}.residual_conv", i, o, 1)
    for name, ch in (("cross_attn2", 2 * c), ("cross_attn3", 4 * c)):
        lin(f"{name}.to_q", ch, 256)
        lin(f"{name}.to_kv", 256, 512)
        lin(f"{name}.proj", 256, ch)
        gn(f"{name}.norm", ch)
        sd[f"{name}.global_tokens"] = torch.randn(1, 64, 256, generator=g)
    gn("attn_bottleneck.norm", 4 * c)
    conv("attn_bottleneck.qkv", 4 * c, 12 * c, 1)
    conv("attn_bottleneck.proj", 4 * c, 4 * c, 1)
    conv("out_conv", c, 3, 1)
    return sd


def test_import_unet_serves_through_the_fused_path(tmp_path):
    """A reference DDPM .pth: the port's tree equals JAX's, loads strictly
    into the port's UNet, and the trainer's fused sampler runs on it."""
    sd = _unet_state_dict(16, 32, torch.Generator().manual_seed(0))
    path = str(tmp_path / "unet.pth")
    torch.save(sd, path)
    uv = PTI.import_unet(path)
    _same_tree(uv, JTI.import_unet(path))
    cfg = PC.DiffusionConfig(
        data=PC.DataConfig(image_size=(16, 16)), timesteps=4, base_ch=16,
        time_emb_dim=32, run=PC.RunConfig(compute_dtype="float32"))
    tr = DiffusionTrainer(cfg, (16, 16, 3), device="cpu")
    PTI.load_into(tr.model, uv)
    assert torch.equal(tr.model_fused.out_conv.weight,
                       sd["out_conv.weight"])
    x = tr.ddim_sample(torch.randn(1, 16, 16, 3), 2, eta=0.0)
    assert x.shape == (1, 16, 16, 3) and torch.isfinite(x).all()
    with pytest.raises(ValueError):
        PTI.load_into(UNet(base_ch=8, time_emb_dim=32), uv)


def _glow_state_dict(k_flows, blocks, c, f, g):
    """A reference-layout Glow state_dict (nf_code.py) of random values."""
    sd = {}
    ch = c
    for i in range(blocks):
        sq = ch * 4
        for k in range(k_flows):
            pre = f"blocks.{i}.flows.{k}"
            sd[f"{pre}.ActNorm.b"] = torch.randn(1, sq, 1, 1, generator=g)
            sd[f"{pre}.ActNorm.s"] = 1 + 0.1 * torch.randn(1, sq, 1, 1,
                                                           generator=g)
            q, _ = torch.linalg.qr(torch.randn(sq, sq, generator=g))
            p, lo, u = torch.linalg.lu(q)
            s = torch.diag(u)
            sd[f"{pre}.InvConv.P"] = p
            sd[f"{pre}.InvConv.L"] = lo
            sd[f"{pre}.InvConv.U"] = torch.triu(u, 1)
            sd[f"{pre}.InvConv.S"] = torch.log(torch.abs(s))
            sd[f"{pre}.InvConv.S_sign"] = torch.sign(s)
            cp = f"{pre}.AffCoupling.neuralnet"
            for name, shape in (("0.weight", (f, sq // 2, 3, 3)),
                                ("0.bias", (f,)), ("2.weight", (f, f, 1, 1)),
                                ("2.bias", (f,)),
                                ("4.conv.weight", (sq // 2, f, 3, 3)),
                                ("4.conv.bias", (sq // 2,)),
                                ("4.scale", (1, sq // 2, 1, 1))):
                sd[f"{cp}.{name}"] = 0.05 * torch.randn(shape, generator=g)
        out = sq if i < blocks - 1 else sq * 2
        cin = sq // 2 if i < blocks - 1 else sq
        sd[f"blocks.{i}.prior.conv.weight"] = 0.01 * torch.randn(
            out, cin, 3, 3, generator=g)
        sd[f"blocks.{i}.prior.conv.bias"] = torch.zeros(out)
        sd[f"blocks.{i}.prior.scale"] = 0.1 * torch.randn(1, out, 1, 1,
                                                          generator=g)
        ch *= 2
    return sd


def test_import_glow_is_exactly_invertible(tmp_path):
    """A reference Glow .pth (``module.``-prefixed, as the reference saves
    it): the port's tree equals JAX's; in the port's Glow the reverse of
    the forward's z gives x back (1e-4)."""
    sd = _glow_state_dict(2, 2, 3, 8, torch.Generator().manual_seed(1))
    path = str(tmp_path / "glow.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    gv = PTI.import_glow(path, n_blocks=2, n_flows=2)
    _same_tree(gv, JTI.import_glow(path, n_blocks=2, n_flows=2))
    model = PTI.load_into(Glow(in_channels=3, n_flows=2, n_blocks=2,
                               filter_size=8), gv)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        _, _, z = model(x)
        back = model.reverse(z, reconstruct=True)
    torch.testing.assert_close(back, x, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ artifacts
def test_grids_panels_and_loss_curves_are_written(tmp_path):
    imgs = torch.rand(10, 4, 6, 3) * 2 - 1
    npy = PA.save_grid(imgs, str(tmp_path / "g.npy"))
    np.testing.assert_array_equal(np.load(npy), imgs.numpy())
    grid = np.asarray(Image.open(str(tmp_path / "g.png")))
    assert grid.shape == (2 * 4, 8 * 6, 3)          # 8 a row, 2 rows
    np.testing.assert_array_equal(grid[:4, :6], np.clip(np.round(
        (imgs[0].numpy() + 1) * 127.5), 0, 255).astype(np.uint8))
    assert PA.save_grid(imgs, str(tmp_path / "h.jpg")) == \
        str(tmp_path / "h.npy")
    assert os.path.exists(tmp_path / "h.jpg")
    PA.save_triplets(imgs[:2], imgs[2:4], imgs[4:6], str(tmp_path / "t.npy"))
    assert np.asarray(Image.open(str(tmp_path / "t.png"))).shape == \
        (3 * 4, 2 * 6, 3)
    path = PA.save_loss_curves({"a": [3.0, 2.0, 1.0], "b": [1.0, 1.5]},
                               str(tmp_path / "losses.jpg"))
    assert path and os.path.getsize(path) > 0
    assert PA.save_loss_curves({}, str(tmp_path / "none.jpg")) is None


def _tiny_ddpm_args(out):
    return ["diffusion", "--epochs", "1", "--steps-per-epoch", "1",
            "--image-size", "16", "--batch-size", "2", "--dataset-size",
            "6", "--timesteps", "4", "--compute-dtype", "float32",
            "--out-dir", str(out), "--device", "cpu"]


def test_debug_nans_sets_anomaly_detection(tmp_path, monkeypatch):
    """``--debug-nans`` trains under autograd's anomaly detection, and
    without it the step runs with it off; the epoch writes its loss curves
    beside the metric log."""
    seen = []
    step = DiffusionTrainer.train_step

    def spy(self, *args, **kwargs):
        seen.append(torch.is_anomaly_enabled())
        return step(self, *args, **kwargs)

    monkeypatch.setattr(DiffusionTrainer, "train_step", spy)
    assert cli.main(_tiny_ddpm_args(tmp_path / "a") + ["--debug-nans"]) == 0
    assert cli.main(_tiny_ddpm_args(tmp_path / "b")) == 0
    assert seen == [True, False]
    assert not torch.is_anomaly_enabled()
    assert os.path.exists(tmp_path / "a" / "diffusion_losses.jpg")
    assert os.path.exists(tmp_path / "a" / "diffusion_loss.npz")
