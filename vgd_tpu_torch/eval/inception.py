"""InceptionV3 features for FID, IS and manifold precision / recall
(``vgd_tpu/eval/inception.py``), an ``nn.Module`` of the FID variant.

The network is pytorch-fid's (what torchmetrics, and so the reference,
computes FID and IS with): average pools that leave the padding out of
their count, Mixed_7b pooling by average and Mixed_7c by maximum, BatchNorm
with eps 1e-3 in eval mode, 1008 TF-layout logits. Input: float NHWC images
in [0, 1], resized bilinearly to 299 x 299 (half-pixel
centres, ``align_corners=False``: the JAX package's ``jax.image.resize``
for every input that grows to 299, which is every size in the repo), then
mapped to [-1, 1]. Taps: the mean over space after the first max pool
(64, the reference's ``feature=64``), after the second (192), after
Mixed_6e (768) and after Mixed_7c (2048), and the logits.

Submodule names are pytorch-fid's (``Conv2d_1a_3x3.conv``, ``.bn``,
``Mixed_5b.branch1x1``, ..., ``fc``), so a user's ``pt_inception``
state_dict loads with ``load_state_dict`` once a ``module.`` prefix is
stripped. Without a file the port draws its own seeded weights (conv
kernels N(0, 2 / fan_in), so the activations keep their scale through the
ReLUs, fc N(0, 1 / fan_in), BatchNorm identity) and tags them
``random-init``: a self-consistent surrogate on which FID is a valid
two-sample statistic but IS means nothing (``eval/metrics.py``). No file is
ever fetched. The convolutions run in full f32 (TF32 off on the card,
``core.rng.resolve_device``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vgd_tpu_torch.core.rng import resolve_device

TAPS = ("64", "192", "768", "2048", "logits")
#: the seed of the port's own random-init weights
INIT_SEED = 0


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3, running statistics) + ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool="avg"``: Mixed_7b (pytorch-fid's FIDInceptionE_1);
    ``pool="max"``: Mixed_7c (FIDInceptionE_2)."""

    def __init__(self, cin, pool):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = _avg_pool(x) if self.pool == "avg" else \
            F.max_pool2d(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


class InceptionV3(nn.Module):
    """The FID-variant InceptionV3, built in eval mode (the BatchNorms use
    their running statistics); ``forward`` returns the taps {64, 192, 768,
    2048, logits} of [0, 1] NHWC float images, without gradient."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes)
        self.eval()

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator] = None
                        ) -> None:
        """Seeded weights: conv kernels N(0, 2 / fan_in), fc N(0, 1 /
        fan_in) with a zero bias, BatchNorm scale 1, bias 0, running mean
        0, variance 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=w.device)
                        * (gain / w[0].numel()) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    @torch.no_grad()
    def forward(self, x_unit: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.interpolate(x_unit.float().permute(0, 3, 1, 2), size=(299, 299),
                          mode="bilinear", align_corners=False)
        x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        out = {"64": x.mean(dim=(2, 3))}
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        out["192"] = x.mean(dim=(2, 3))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        out["768"] = x.mean(dim=(2, 3))
        for name in ("Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        out["2048"] = x.mean(dim=(2, 3))
        out["logits"] = self.fc(out["2048"])
        return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch InceptionV3 state_dict file (pytorch-fid or torchvision
    names), on the CPU, without a ``module.`` prefix. Keys missing a
    BatchNorm's ``num_batches_tracked`` load as 0 (the dict carries no
    version metadata)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def build_inception(weights_path: Optional[str] = None, device="cuda"
                    ) -> Tuple[InceptionV3, str]:
    """(model on ``device`` in eval mode, tag): the weights of
    ``weights_path`` (the fc width from its ``fc.weight``) and the path as
    tag, or the port's seeded init (drawn on the CPU, so every device gets
    the same weights) tagged ``random-init``."""
    device = resolve_device(device)
    if weights_path:
        sd = load_state_dict_file(weights_path)
        model = InceptionV3(num_classes=sd["fc.weight"].shape[0])
        model.load_state_dict(sd, strict=True)
        tag = weights_path
    else:
        model = InceptionV3()
        model.init_parameters(torch.Generator().manual_seed(INIT_SEED))
        tag = "random-init"
    return model.to(device).eval(), tag


def load_inception(weights_path: Optional[str] = None, feature: str = "64",
                   device="cuda"):
    """(feature_fn, tag). ``feature_fn``: uint8 NHWC images (a tensor or a
    numpy array) -> (tap ``feature``, logits), f32 tensors on ``device``;
    it carries ``weights_tag`` (the tag) and ``model``."""
    if feature not in TAPS[:-1]:
        raise ValueError(f"feature {feature!r}, one of {TAPS[:-1]}")
    model, tag = build_inception(weights_path, device)
    dev = next(model.parameters()).device

    def feature_fn(x_uint8):
        x = torch.as_tensor(x_uint8).to(dev).float() / 255.0
        out = model(x)
        return out[feature], out["logits"]

    feature_fn.weights_tag = tag
    feature_fn.model = model
    return feature_fn, tag
