"""Inception-v3 in eval mode for FID and IS (the JAX package's
eval/inception_v3.py; reference multi_stylegan/validation_metrics.py:16-154,
571-615).

NCHW, with torchvision's ``inception_v3`` parameter and buffer names, so a
torchvision state dict loads with ``load_state_dict(strict=True)``: conv
without bias + BatchNorm (eps 1e-3) + ReLU blocks, ``transform_input`` on (as
the pretrained constructor sets it), ``avg_pool2d(3, 1, 1)`` with
``count_include_pad=True`` in the pool branches, the 2048-d global pool and
the 1000-way ``fc``.  The auxiliary head (``AuxLogits``) holds parameters
only so that a state dict saved with it loads; no forward uses it.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, **kw) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool3(x)),
        ], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2),
        ], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(bd))
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_2(self.branch7x7x3_1(x))
        return torch.cat([
            self.branch3x3_2(self.branch3x3_1(x)),
            self.branch7x7x3_4(self.branch7x7x3_3(b7)),
            F.max_pool2d(x, 3, stride=2),
        ], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionAux(nn.Module):
    """torchvision's auxiliary classifier: parameters only (see the module
    docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.conv0 = BasicConv2d(768, 128, kernel_size=1)
        self.conv1 = BasicConv2d(128, 768, kernel_size=5)
        self.fc = nn.Linear(768, 1000)


class InceptionV3(nn.Module):
    """Input [B, 3, 299, 299] in [-1, 1] (after the caller's renormalization)."""

    def __init__(self, aux_logits: bool = True) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.AuxLogits = InceptionAux() if aux_logits else None
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        """The 2048-d pool (``features_only``) or the class logits."""
        x = torch.cat([x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,  # transform_input
                       x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                       x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], 1)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        pooled = x.mean(dim=(2, 3))
        return pooled if features_only else self.fc(pooled)


def inception_from_state_dict(sd: Mapping[str, torch.Tensor]) -> InceptionV3:
    """An eval-mode :class:`InceptionV3` holding a torchvision state dict
    (with or without the auxiliary head), loaded strictly."""
    model = InceptionV3(aux_logits=any(k.startswith("AuxLogits.") for k in sd))
    model.load_state_dict(sd, strict=True)
    return model.eval()
