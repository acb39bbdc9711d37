"""U-Net discriminator with scalar and pixel-wise heads (PyTorch, NCHW in
channels_last memory).

Architecture: reference multi_stylegan/u_net_2d_discriminator.py and the
JAX package's models/discriminator.py: a 5-block encoder (NonLocal at index
2, minibatch std-dev in the last two ResNet blocks) with k3 s2 p0 downscale
convs and blurs, a scalar head on the pooled bottleneck, a 4-block decoder
(NonLocal at index 1) of blur-upsamples, 1x1 convs and U-Net skip concats,
and a pixel head.  Input ``[B, C, T, H, W]``; returns ``(scalar [B, 1],
pixel [B, 1, 1, H, W])`` in f32 whatever the compute dtype.

State-dict keys and shapes are the reference's (what the JAX package's
``export_discriminator`` emits).  With ``config.remat`` each encoder and
decoder block at >= ``remat_min_px`` pixels is recomputed in the backward
pass (``torch.utils.checkpoint``, non-reentrant, so R1's double backward
goes through it).  ``forward`` takes a per-call compute dtype and remat, so
the trainer's f32 R1 runs the same module and ``Parameter``s as its bf16
steps.  With ``config.fft`` the input is widened by the normalised 3-D FFT
over (T, H, W) of each domain, real and imaginary parts as 2·C·T more
channels (u_net_2d_discriminator.py:106-122; JAX discriminator.py:71-83),
computed on the f32 input by cuFFT (``torch.fft``) and cast afterwards.

The cut-mix helpers at the end take their cut coordinates, corner and
inversion from the caller's draws (u_net_2d_discriminator.py:384-448).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gpu_bench.reference.config import DiscriminatorConfig
from gpu_bench.reference.attention import NonLocalBlock
from gpu_bench.reference.equalized import EqualizedConv2d, EqualizedLinear, FusedLeakyReLU
from gpu_bench.reference.normalization import minibatch_std_dev
from gpu_bench.reference.blur import Blur, blur, blur_padding, upsample2x

_CL = torch.channels_last


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=_CL).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


class ResNetBlock(nn.Module):
    """Two k3 equalized convs + leaky ReLU, a 1x1 residual when the channels
    change, an optional minibatch-std-dev input channel, output / sqrt(2)
    (u_net_2d_discriminator.py:143-186)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mini_batch_std_dev: bool = False, device=None):
        super().__init__()
        self.mini_batch_std_dev = mini_batch_std_dev
        extra = 1 if mini_batch_std_dev else 0
        self.main_mapping = nn.Sequential(
            EqualizedConv2d(in_channels + extra, out_channels, 3, 1, 1, bias=False, device=device),
            FusedLeakyReLU(out_channels, device=device),
            EqualizedConv2d(out_channels, out_channels, 3, 1, 1, bias=False, device=device),
            FusedLeakyReLU(out_channels, device=device),
        )
        if in_channels != out_channels:
            self.residual_mapping = EqualizedConv2d(
                in_channels, out_channels, 1, 1, 0, bias=False, device=device)
        else:
            self.residual_mapping = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = minibatch_std_dev(x) if self.mini_batch_std_dev else x
        y = self.main_mapping(y)
        res = x if self.residual_mapping is None else self.residual_mapping(x)
        return (y + res) / math.sqrt(2.0)


class _MeanPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))


class Discriminator(nn.Module):
    """U-Net discriminator (u_net_2d_discriminator.py:14-140)."""

    def __init__(self, config: DiscriminatorConfig = DiscriminatorConfig(), device=None):
        super().__init__()
        self.config = cfg = config
        enc, dec = cfg.encoder_channels, cfg.decoder_channels
        n_enc = len(enc)
        # the fft features add real and imaginary parts of every input channel
        cin = cfg.input_channels * (3 if cfg.fft else 1)
        blocks = []
        for i, (_, cout) in enumerate(enc):
            if i == 2:
                blocks.append(NonLocalBlock(cin, cout, device=device))
            else:
                blocks.append(ResNetBlock(cin, cout, i >= n_enc - 2, device=device))
            cin = cout
        self.encoder_blocks = nn.ModuleList(blocks)
        self.downscale_convolutions = nn.ModuleList(
            nn.Sequential(EqualizedConv2d(cout, cout, 3, 2, 0, device=device), Blur(device=device))
            for _, cout in enc[:-1])
        self.classification_head = nn.Sequential(
            _MeanPool(), nn.Identity(),
            EqualizedLinear(enc[-1][1], 128, bias=False, device=device),
            FusedLeakyReLU(128, device=device),
            EqualizedLinear(128, 1, bias=False, device=device))
        blocks, ups = [], []
        cin = enc[-1][1]
        for i, (din, dout) in enumerate(dec):
            skip_c = enc[n_enc - 2 - i][1]
            ups.append(nn.Sequential(
                Blur(device=device),
                EqualizedConv2d(cin, din - skip_c, 1, 1, 0, bias=False, device=device)))
            if i == 1:
                blocks.append(NonLocalBlock(din, dout, device=device))
            else:
                blocks.append(ResNetBlock(din, dout, device=device))
            cin = dout
        self.decoder_blocks = nn.ModuleList(blocks)
        self.transposed_convolutions = nn.ModuleList(ups)
        self.final_mapping = nn.Sequential(
            FusedLeakyReLU(dec[-1][-1], device=device),
            EqualizedConv2d(dec[-1][-1], 1, 1, 1, 0, bias=False, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference init from ``generator`` (CPU): weights ~N(0, 1),
        biases and ``gamma`` 0."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight"):
                    p.copy_(torch.randn(p.shape, generator=generator))
                else:
                    p.zero_()

    def _block(self, remat: bool, block: nn.Module, y: torch.Tensor, px: int) -> torch.Tensor:
        if remat and px >= self.config.remat_min_px and torch.is_grad_enabled():
            return checkpoint(block, y, use_reentrant=False)
        return block(y)

    def forward(self, x: torch.Tensor, *, compute_dtype: Optional[str] = None,
                remat: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``compute_dtype`` / ``remat`` override the config's for this call."""
        cfg = self.config
        if x.dim() != 5:
            raise ValueError(f"expected [B, C, T, H, W], got {tuple(x.shape)}")
        b, c, t, h, w = x.shape
        dtype = getattr(torch, compute_dtype or cfg.compute_dtype)
        remat = cfg.remat if remat is None else remat
        y = x.reshape(b, c * t, h, w).to(dtype)
        if cfg.fft:
            f = torch.fft.fftn(x.float(), dim=(-3, -2, -1), norm="ortho")
            parts = torch.stack([f.real, f.imag], dim=2)  # [B, C, 2, T, H, W]
            y = torch.cat([y, parts.reshape(b, 2 * c * t, h, w).to(dtype)], dim=1)
        y = y.contiguous(memory_format=_CL)
        n_enc = len(self.encoder_blocks)
        pad = blur_padding(4, 2, 3)
        features: List[torch.Tensor] = []
        for i, block in enumerate(self.encoder_blocks):
            y = self._block(remat, block, y, h >> i)
            if i != n_enc - 1:
                features.append(y)
                conv, blur_mod = self.downscale_convolutions[i]
                y = _nchw(blur(_nhwc(conv(y)), blur_mod.kernel, pad))
        head = self.classification_head
        cls = head[4](head[3](head[2](head[0](y))))
        for i, block in enumerate(self.decoder_blocks):
            up_mod, conv = self.transposed_convolutions[i]
            up = conv(_nchw(upsample2x(_nhwc(y), kernel=up_mod.kernel)))
            y = torch.cat([up, features[-(i + 1)]], dim=1)
            y = self._block(remat, block, y, (h >> (n_enc - 1)) << (i + 1))
        y = self.final_mapping(y)
        return cls.float(), y[:, :, None].float()


# ---------------------------------------------------------------- cut-mix


def cut_mix_coordinate_ranges(height: int, width: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """[low, high) of the cut row and column draws: [0.1, 0.9) of the extent."""
    return ((int(0.1 * height), int(0.9 * height)), (int(0.1 * width), int(0.9 * width)))


def binary_cut_mix_map(cut: Tuple[int, int, bool, bool], height: int, width: int,
                       device=None) -> torch.Tensor:
    """Axis-aligned quadrant map [1, 1, 1, H, W] in {0, 1}
    (u_net_2d_discriminator.py:426-448).  ``cut`` = (row, col, corner,
    invert): the cut point, lower-right (True) or upper-left quadrant, and
    whether the map is inverted."""
    ch, cw, corner, invert = (torch.as_tensor(v, device=device) for v in cut)
    rows = torch.arange(height, device=device)[:, None]
    cols = torch.arange(width, device=device)[None, :]
    m = torch.where(corner, (rows >= ch) & (cols >= cw), (rows < ch) & (cols < cw)).float()
    m = torch.where(invert, 1.0 - m, m)
    return m[None, None, None]


def generate_cut_mix_augmentation_data(cut, image_real: torch.Tensor, image_fake: torch.Tensor):
    """Mixed real/fake input + per-pixel label (u_net_2d_discriminator.py:384-399)."""
    image_fake = image_fake[: image_real.shape[0]]
    target = binary_cut_mix_map(cut, image_real.shape[-2], image_real.shape[-1],
                                image_real.device)
    return image_real * target + image_fake * (1.0 - target), target


def generate_cut_mix_transformation_data(cut, image_real, image_fake, prediction_real,
                                         prediction_fake):
    """Mixed input + soft consistency target from per-pixel predictions
    (u_net_2d_discriminator.py:402-423)."""
    image_fake = image_fake[: image_real.shape[0]]
    prediction_fake = prediction_fake[: image_real.shape[0]]
    m = binary_cut_mix_map(cut, image_real.shape[-2], image_real.shape[-1], image_real.device)
    return (image_real * m + image_fake * (1.0 - m),
            prediction_real * m + prediction_fake * (1.0 - m))
