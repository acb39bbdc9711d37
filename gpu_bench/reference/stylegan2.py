"""StyleGAN2's generator (Karras et al., arXiv:1912.04958; config F at
1024x1024) in plain PyTorch, f32: the reference that the port's one-tower
generator (``num_domains=1``, k3 up-convs, skip gain 4, a toRGB bias per
channel) is held to.

The published formulation, not the port's: every modulated conv builds its
per-sample weights (style times weight, then demodulated) and runs one
grouped convolution over the batch, and the FIR filters are rosinality's
``upfirdn2d_native`` (zero-stuff, pad, a depthwise convolution with the
flipped taps).  Nothing here imports the port, ``jax`` or the JAX package.

Departures from NVlabs' code, as the port has them:

* the transposed conv takes its weight unflipped, and the blur after it
  pads ((p + 1) // 2 + 1, p // 2 + 1) with p = taps - 2 - (k - 1), as
  rosinality's stylegan2-pytorch does (NVlabs flips the weight);
* the equalized learning rate is Multi-StyleGAN's: every weight is scaled
  at run time by sqrt(2 / fan_in), every affine bias by sqrt(2 / fan_out),
  and the leaky ReLU has gain 1 (NVlabs: 1 / sqrt(fan_in) for the affines
  and toRGB, gain sqrt(2));
* the mapping has no learning-rate multiplier: NVlabs' 0.01 is folded into
  the seeded weights (the weights are drawn, not trained, here).

Its leaves carry the port's state-dict names in the port's order, so that
``weights.make_weights`` fills both from one seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class StyleGAN2Config:
    """The generator block of a configuration file (the port's
    ``GeneratorConfig`` keys that this network reads)."""

    channels: Tuple[int, ...]
    latent_dimensions: int = 512
    depth_style_mapping: int = 8
    starting_resolution: Tuple[int, int] = (4, 4)
    sequence_length: int = 3
    blur_taps: Tuple[int, ...] = (1, 3, 3, 1)
    up_kernel_size: int = 3
    skip_upsample_gain: float = 4.0
    rgb_bias_per_channel: bool = True

    @classmethod
    def from_block(cls, block: dict) -> "StyleGAN2Config":
        """From a configuration file's ``generator`` block: one tower, f32,
        no channel factor; the keys this network does not read (remat,
        the compute dtype) are left out."""
        if block.get("num_domains", 1) != 1 or block.get("channel_factor", 1) != 1:
            raise ValueError("StyleGAN2 is one tower at its published widths")
        if block.get("compute_dtype", "float32") != "float32":
            raise ValueError("the reference runs in f32")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in block.items()
              if k in names}
        return cls(**kw)

    @property
    def n_stages(self) -> int:
        return len(self.channels) - 1

    @property
    def n_latents(self) -> int:
        return 2 * self.n_stages + 2


def fir_kernel(taps: Sequence[int], gain: float, device=None) -> torch.Tensor:
    k = torch.tensor(taps, dtype=torch.float32, device=device)
    k = k[None, :] * k[:, None]
    return k / k.sum() * gain


def upfirdn2d_native(x: torch.Tensor, kernel: torch.Tensor, up: int,
                     pad: Tuple[int, int]) -> torch.Tensor:
    """NCHW: zero-stuff by ``up``, pad (pad0, pad1) on both axes, then the
    true convolution with ``kernel`` as a depthwise conv2d (rosinality's
    ``upfirdn2d_native`` at down 1)."""
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(b, c, h * up, w * up)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    taps = torch.flip(kernel, [0, 1]).to(x.dtype)[None, None]
    y = F.conv2d(x.reshape(b * c, 1, *x.shape[2:]), taps)
    return y.reshape(b, c, *y.shape[2:])


def up_blur_padding(n_taps: int, k: int) -> Tuple[int, int]:
    p = (n_taps - 2) - (k - 1)
    return ((p + 1) // 2 + 1, p // 2 + 1)


def leaky_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bias + leaky ReLU (slope 0.2, gain 1) over the channels (dim 1)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return F.leaky_relu(x + bias.view(shape), 0.2)


class Linear(nn.Module):
    """Equalized linear: x @ (W sqrt(2 / in)).T + b sqrt(2 / out)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.ones(d_out, device=device)) if bias else None
        self.scale, self.scale_bias = math.sqrt(2.0 / d_in), math.sqrt(2.0 / d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ (self.weight * self.scale).t()
        return y if self.bias is None else y + self.bias * self.scale_bias


class Activation(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.bias)


class Mapping(nn.Module):
    """z -> w: normalize z, then ``depth`` equalized linear layers with bias +
    leaky ReLU (``layers.{1+2i}.weight``, ``layers.{2+2i}.bias``)."""

    def __init__(self, dim: int, depth: int, device=None):
        super().__init__()
        layers: List[nn.Module] = [nn.Identity()]
        for _ in range(depth):
            layers += [Linear(dim, dim, False, device), Activation(dim, device)]
        self.layers = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.layers(z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + EPS))


class ModConv(nn.Module):
    """Modulated conv with per-sample weights and one grouped convolution;
    the upsampling form is a stride-2 transposed conv followed by the
    gain-4 blur."""

    def __init__(self, c_in: int, c_out: int, k: int, dim: int, demodulate: bool, up: bool,
                 taps: Sequence[int], device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, c_out, c_in, k, k, device=device))
        self.modulation_mapping = Linear(dim, c_in, True, device)
        self.k, self.demodulate, self.up = k, demodulate, up
        self.scale = math.sqrt(2.0 / (c_in * k * k))
        if up:
            self.register_buffer("blur", fir_kernel(taps, 4.0, device))
            self.pad = up_blur_padding(len(taps), k)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        b, c_in, h, wd = x.shape
        style = self.modulation_mapping(w)
        weight = self.scale * self.weight * style[:, None, :, None, None]  # [B, O, I, k, k]
        if self.demodulate:
            weight = weight * torch.rsqrt(weight.square().sum(dim=(2, 3, 4)) + EPS)[
                :, :, None, None, None]
        c_out, k = weight.shape[1], self.k
        x = x.reshape(1, b * c_in, h, wd)
        if self.up:
            weight = weight.transpose(1, 2).reshape(b * c_in, c_out, k, k)
            y = F.conv_transpose2d(x, weight, stride=2, groups=b)
            y = y.reshape(b, c_out, *y.shape[2:])
            return upfirdn2d_native(y, self.blur, 1, self.pad)
        y = F.conv2d(x, weight.reshape(b * c_out, c_in, k, k), padding=k // 2, groups=b)
        return y.reshape(b, c_out, h, wd)


class Noise(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return x + self.weight * noise


class StyledConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, dim: int, up: bool, taps, device=None):
        super().__init__()
        self.modulated_convolution = ModConv(c_in, c_out, k, dim, True, up, taps, device)
        self.noise_injection = Noise(device)
        self.activation = Activation(c_out, device)

    def forward(self, x, w, noise):
        return self.activation(self.noise_injection(self.modulated_convolution(x, w), noise))


class ToRGB(nn.Module):
    """k1 modulated conv, not demodulated, + bias, + the skip upsampled by
    upfirdn2d(up=2) with the taps times ``gain``."""

    def __init__(self, c_in: int, c_out: int, dim: int, up: bool, taps, gain: float,
                 per_channel: bool, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1, c_out if per_channel else 1, 1, 1,
                                             device=device))
        self.modulated_convolution = ModConv(c_in, c_out, 1, dim, False, False, taps, device)
        if up:
            self.register_buffer("upsampling", fir_kernel(taps, gain, device))
            p = len(taps) - 2
            self.pad = ((p + 1) // 2 + 1, p // 2)

    def forward(self, x, w, skip=None):
        y = self.modulated_convolution(x, w) + self.bias
        if skip is not None:
            y = y + upfirdn2d_native(skip, self.upsampling, 2, self.pad)
        return y


class Const(nn.Module):
    def __init__(self, channels: int, size: Tuple[int, int], device=None):
        super().__init__()
        self.input = nn.Parameter(torch.ones(1, channels, *size, device=device))


class Generator(nn.Module):
    """z [B, D] -> images [B, 1, T, H, W] (the port's layout: one domain)."""

    def __init__(self, cfg: StyleGAN2Config, device=None):
        super().__init__()
        self.cfg = cfg
        ch, d, taps, t = cfg.channels, cfg.latent_dimensions, cfg.blur_taps, cfg.sequence_length
        rgb = dict(gain=cfg.skip_upsample_gain, per_channel=cfg.rgb_bias_per_channel,
                   device=device)
        self.style_mapping = Mapping(d, cfg.depth_style_mapping, device)
        self.constant_input_1 = Const(ch[0], cfg.starting_resolution, device)
        self.starting_convolution_1 = StyledConv(ch[0], ch[0], 3, d, False, taps, device)
        self.starting_output_block_1 = ToRGB(ch[0], t, d, False, taps, **rgb)
        self.main_convolutions_1 = nn.ModuleList()
        self.output_blocks_1 = nn.ModuleList()
        for i in range(cfg.n_stages):
            self.main_convolutions_1.append(
                StyledConv(ch[i], ch[i + 1], cfg.up_kernel_size, d, True, taps, device))
            self.main_convolutions_1.append(
                StyledConv(ch[i + 1], ch[i + 1], 3, d, False, taps, device))
            self.output_blocks_1.append(ToRGB(ch[i + 1], t, d, True, taps, **rgb))
        self.noises = nn.Module()
        for i, (h, w) in enumerate(self.noise_shapes()):
            self.noises.register_buffer("noise_start" if i == 0 else f"noise_{i - 1}",
                                        torch.zeros(1, 1, h, w, device=device))

    def noise_shapes(self) -> List[Tuple[int, int]]:
        h0, w0 = self.cfg.starting_resolution
        out = [(h0, w0)]
        for i in range(self.cfg.n_stages):
            out += [(h0 * 2 ** (i + 1), w0 * 2 ** (i + 1))] * 2
        return out

    def synthesize(self, ws: torch.Tensor, noise: Sequence[torch.Tensor]) -> torch.Tensor:
        """ws [B, n_latents, D] -> [B, 1, T, H, W]."""
        b = ws.shape[0]
        x = self.constant_input_1.input.expand(b, -1, -1, -1)
        x = self.starting_convolution_1(x, ws[:, 0], noise[0])
        skip = self.starting_output_block_1(x, ws[:, 1])
        for i in range(self.cfg.n_stages):
            x = self.main_convolutions_1[2 * i](x, ws[:, 2 * i + 1], noise[2 * i + 1])
            x = self.main_convolutions_1[2 * i + 1](x, ws[:, 2 * i + 2], noise[2 * i + 2])
            skip = self.output_blocks_1[i](x, ws[:, 2 * i + 3], skip)
        return skip[:, None]

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """One latent per sample (no style mixing); fresh N(0, 1) noise from
        ``generator`` per layer, in layer order, as the port draws it."""
        w = self.style_mapping(z)
        ws = w[:, None].expand(-1, self.cfg.n_latents, -1)
        if noise is None:
            noise = [torch.randn((z.shape[0], 1, h, wd), generator=generator,
                                 device=z.device) for h, wd in self.noise_shapes()]
        return self.synthesize(ws, noise)
