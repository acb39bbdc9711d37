"""Inception-v1 I3D in eval mode, FVD's feature extractor (the JAX package's
eval/i3d.py; reference multi_stylegan/validation_metrics.py:361-398,
631-951).

NCDHW, with pytorch-i3d's ``InceptionI3d`` parameter and buffer names
(``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_3b.b1b.bn.running_mean``, ...), so
an ``rgb_imagenet.pt`` state dict loads with ``load_state_dict(strict=True)``.
Endpoints run through Mixed_5c; the features are its global average,
[B, 1024].  The 400-way ``logits`` unit is built only when the state dict
holds it, and no forward uses it.

Padding is TensorFlow's "SAME", as the JAX net's ``lax`` convolutions and
max pools use it and the reference computes it (compute_pad): per dimension
of size n, kernel k and stride s, a total of ``max(k - s, 0)`` if
``n % s == 0`` else ``max(k - n % s, 0)``, the smaller half in front.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Triple = Tuple[int, int, int]


def same_pad(x: torch.Tensor, kernel: Triple, stride: Triple) -> torch.Tensor:
    """Zero-pad the (T, H, W) dims of an NCDHW tensor for a "SAME" window."""
    pads = []
    for dim, k, s in zip((4, 3, 2), kernel[::-1], stride[::-1]):  # F.pad: last dim first
        n = x.shape[dim]
        total = max(k - s, 0) if n % s == 0 else max(k - n % s, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Unit3D(nn.Module):
    """conv3d ("SAME", no bias) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Triple = (1, 1, 1),
                 stride: Triple = (1, 1, 1), use_batch_norm: bool = True,
                 use_bias: bool = False, activation: bool = True) -> None:
        super().__init__()
        self.kernel, self.stride, self.activation = kernel, stride, activation
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride=stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(cout, eps=0.001, momentum=0.01) if use_batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(same_pad(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


def max_pool_same(x: torch.Tensor, kernel: Triple, stride: Triple) -> torch.Tensor:
    # Zero padding, where the JAX pool pads with -inf: the two agree because
    # every pool input here follows a ReLU, so no window's max is below 0.
    return F.max_pool3d(same_pad(x, kernel, stride), kernel, stride)


class InceptionModule(nn.Module):
    """Four-branch 3D inception block; ``channels`` = (b0, b1a, b1b, b2a,
    b2b, b3b)."""

    def __init__(self, cin: int, channels: Sequence[int]) -> None:
        super().__init__()
        c = channels
        self.b0 = Unit3D(cin, c[0])
        self.b1a = Unit3D(cin, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(cin, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(cin, c[5])

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))], 1)


# (name, kind, spec) in order; pools carry (kernel, stride)
LAYOUT = (
    ("Conv3d_1a_7x7", "unit", (3, 64, (7, 7, 7), (2, 2, 2))),
    ("MaxPool3d_2a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", "unit", (64, 64, (1, 1, 1), (1, 1, 1))),
    ("Conv3d_2c_3x3", "unit", (64, 192, (3, 3, 3), (1, 1, 1))),
    ("MaxPool3d_3a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", "mixed", (192, (64, 96, 128, 16, 32, 32))),
    ("Mixed_3c", "mixed", (256, (128, 128, 192, 32, 96, 64))),
    ("MaxPool3d_4a_3x3", "pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", "mixed", (480, (192, 96, 208, 16, 48, 64))),
    ("Mixed_4c", "mixed", (512, (160, 112, 224, 24, 64, 64))),
    ("Mixed_4d", "mixed", (512, (128, 128, 256, 24, 64, 64))),
    ("Mixed_4e", "mixed", (512, (112, 144, 288, 32, 64, 64))),
    ("Mixed_4f", "mixed", (528, (256, 160, 320, 32, 128, 128))),
    ("MaxPool3d_5a_2x2", "pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", "mixed", (832, (256, 160, 320, 32, 128, 128))),
    ("Mixed_5c", "mixed", (832, (384, 192, 384, 48, 128, 128))),
)


class InceptionI3D(nn.Module):
    """Input [B, 3, T, H, W] in [-1, 1]; output [B, 1024]."""

    def __init__(self, num_classes: int = 0) -> None:
        super().__init__()
        self._pools = {}
        for name, kind, spec in LAYOUT:
            if kind == "unit":
                setattr(self, name, Unit3D(*spec))
            elif kind == "mixed":
                setattr(self, name, InceptionModule(*spec))
            else:
                self._pools[name] = spec
        self.logits = (Unit3D(1024, num_classes, use_batch_norm=False, use_bias=True,
                              activation=False) if num_classes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, kind, _ in LAYOUT:
            x = max_pool_same(x, *self._pools[name]) if kind == "pool" else getattr(self, name)(x)
        return x.mean(dim=(2, 3, 4))


def i3d_from_state_dict(sd: Mapping[str, torch.Tensor]) -> InceptionI3D:
    """An eval-mode :class:`InceptionI3D` holding a pytorch-i3d state dict
    (with or without the logits unit), loaded strictly."""
    w = sd.get("logits.conv3d.weight")
    model = InceptionI3D(num_classes=0 if w is None else w.shape[0])
    model.load_state_dict(sd, strict=True)
    return model.eval()
