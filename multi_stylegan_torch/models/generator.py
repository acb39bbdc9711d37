"""Dual-tower Multi-StyleGAN generator (PyTorch, NCHW in channels_last memory).

Architecture: reference multi_stylegan/multi_stylegan_generator.py and the
JAX package's models/generator.py.  Tower-1 blocks own the style affine and
return the modulated style ``s``, which the matching tower-2 block consumes
directly, so both imaging domains share one style trajectory.

Port decisions:
* activations are NCHW tensors in ``torch.channels_last`` memory, so
  ``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view that goes to the
  kernels (fused leaky-ReLU, upfirdn2d) with no copy;
* per-sample modulated weights never exist (ops/modulated_conv.py);
* state-dict keys and shapes are the reference's, exactly what the JAX
  package's ``export_generator`` emits, so a reference checkpoint's
  ``generator_ema`` loads with ``load_state_dict(strict=True)``;
* the images are ``[B, domains, T, H, W]`` in f32 whatever the compute dtype;
* with ``config.remat`` and gradients on, each styled-conv and output block
  at >= ``remat_min_px`` pixels is recomputed in the backward pass
  (``torch.utils.checkpoint``, non-reentrant, so path length's double
  backward goes through it), as the JAX package's ``nn.remat`` blocks are.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multi_stylegan_torch.models.config import GeneratorConfig
from multi_stylegan_torch.nn.equalized import EqualizedLinear, FusedLeakyReLU
from multi_stylegan_torch.nn.normalization import pixel_norm
from multi_stylegan_torch.ops.blur import Blur, blur, blur_padding, upsample2x
from multi_stylegan_torch.ops.modulated_conv import (
    modulated_conv2d,
    modulated_conv_transpose2d,
)

_CL = torch.channels_last


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=_CL).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2)


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


class StyleMapping(nn.Module):
    """z -> w: PixelNorm + depth x (EqualizedLinear -> FusedLeakyReLU)
    (multi_stylegan_generator.py:208-235); ``layers.{1+2i}.weight`` and
    ``layers.{2+2i}.bias`` as in the reference."""

    def __init__(self, latent_dim: int = 512, depth: int = 8, device=None):
        super().__init__()
        layers: List[nn.Module] = [PixelNorm()]
        for _ in range(depth):
            layers.append(EqualizedLinear(latent_dim, latent_dim, bias=False, device=device))
            layers.append(FusedLeakyReLU(latent_dim, device=device))
        self.layers = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.layers(z)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv (multi_stylegan_generator.py:295-414).

    ``modulation_mapping=True`` owns the style affine (bias init 1.0) and
    returns ``(y, s)``; ``False`` consumes an already-modulated style.
    The upsampling variant is a k2 s2 transposed conv followed by the gain-4
    blur with ``blur_padding(len(taps), 2, k)``.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True, upsampling: bool = False,
                 modulation_mapping: bool = True,
                 blur_taps: Tuple[int, ...] = (1, 3, 3, 1), device=None):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.demodulate = demodulate
        self.upsampling = upsampling
        self.has_mapping = modulation_mapping
        self.scale = math.sqrt(2.0) / math.sqrt(in_channels * k * k)
        self.weight = nn.Parameter(
            torch.empty(1, out_channels, in_channels, k, k, device=device))
        if modulation_mapping:
            self.modulation_mapping = EqualizedLinear(
                style_dim, in_channels, bias_init=1.0, device=device)
        if upsampling:
            self.blur = Blur(blur_taps, gain=4.0, device=device)
            self.blur_pad = blur_padding(len(blur_taps), 2, k)

    def forward(self, x: torch.Tensor, style: torch.Tensor):
        s = self.modulation_mapping(style) if self.has_mapping else style
        w = self.weight[0]
        if self.upsampling:
            y = modulated_conv_transpose2d(
                x, w, s, scale=self.scale, demodulate=self.demodulate, stride=2)
            y = _nchw(blur(_nhwc(y), self.blur.kernel, self.blur_pad))
        else:
            y = modulated_conv2d(x, w, s, scale=self.scale, demodulate=self.demodulate,
                                 padding=self.kernel_size // 2)
        if self.has_mapping:
            return y, s
        return y


class NoiseInjection(nn.Module):
    """x + weight * noise, one learnable scalar; noise is [B-or-1, 1, H, W]."""

    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class StyledConv2d(nn.Module):
    """ModulatedConv2d -> NoiseInjection -> FusedLeakyReLU
    (multi_stylegan_generator.py:417-469)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 style_dim: int, upsampling: bool, modulation_mapping: bool,
                 blur_taps: Tuple[int, ...], device=None):
        super().__init__()
        self.has_mapping = modulation_mapping
        self.modulated_convolution = ModulatedConv2d(
            in_channels, out_channels, kernel_size, style_dim, True, upsampling,
            modulation_mapping, blur_taps, device=device)
        self.noise_injection = NoiseInjection(device=device)
        self.activation = FusedLeakyReLU(out_channels, device=device)

    def forward(self, x, style, noise):
        if self.has_mapping:
            y, s = self.modulated_convolution(x, style)
        else:
            y = self.modulated_convolution(x, style)
        y = self.activation(self.noise_injection(y, noise))
        if self.has_mapping:
            return y, s
        return y


class OutputBlock(nn.Module):
    """k1 non-demodulated modulated conv + scalar bias + blur-upsampled skip
    (multi_stylegan_generator.py:472-526)."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 upsampling: bool, modulation_mapping: bool,
                 blur_taps: Tuple[int, ...], device=None):
        super().__init__()
        self.has_mapping = modulation_mapping
        self.has_upsampling = upsampling
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, 1, device=device))
        self.modulated_convolution = ModulatedConv2d(
            in_channels, out_channels, 1, style_dim, demodulate=False,
            upsampling=False, modulation_mapping=modulation_mapping, device=device)
        if upsampling:
            # Reference Upsample: plain normalized kernel, NO factor**2 gain
            self.upsampling = Blur(blur_taps, gain=1.0, device=device)

    def forward(self, x, style, skip=None):
        if self.has_mapping:
            y, s = self.modulated_convolution(x, style)
        else:
            y = self.modulated_convolution(x, style)
        y = y + self.bias.to(y.dtype)
        if skip is not None:
            if self.has_upsampling:
                skip = _nchw(upsample2x(_nhwc(skip), kernel=self.upsampling.kernel))
            y = y + skip
        if self.has_mapping:
            return y, s
        return y


class ConstantInput(nn.Module):
    def __init__(self, channels: int, size: Tuple[int, int], device=None):
        super().__init__()
        self.input = nn.Parameter(torch.ones(1, channels, *size, device=device))


class Generator(nn.Module):
    """Dual-tower synthesis network. Output: [B, num_domains, T, H, W] f32."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig(), device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        ch = cfg.stage_channels
        taps = cfg.blur_taps
        d = cfg.latent_dimensions
        t = cfg.sequence_length
        h0, w0 = cfg.starting_resolution
        self.style_mapping = StyleMapping(d, cfg.depth_style_mapping, device=device)
        for tower, mm in ((1, True), (2, False)):
            setattr(self, f"constant_input_{tower}", ConstantInput(ch[0], (h0, w0), device))
            setattr(self, f"starting_convolution_{tower}", StyledConv2d(
                ch[0], ch[0], 3, d, False, mm, taps, device))
            setattr(self, f"starting_output_block_{tower}", OutputBlock(
                ch[0], t, d, False, mm, taps, device))
            convs, outs = nn.ModuleList(), nn.ModuleList()
            for i in range(cfg.n_stages):
                convs.append(StyledConv2d(ch[i], ch[i + 1], 2, d, True, mm, taps, device))
                convs.append(StyledConv2d(ch[i + 1], ch[i + 1], 3, d, False, mm, taps, device))
                outs.append(OutputBlock(ch[i + 1], t, d, True, mm, taps, device))
            setattr(self, f"main_convolutions_{tower}", convs)
            setattr(self, f"output_blocks_{tower}", outs)
        # Fixed-noise buffers for deterministic eval (multi_stylegan_generator.py:87-95)
        self.noises = nn.Module()
        for idx, (h, w) in enumerate(self._noise_shapes()):
            name = "noise_start" if idx == 0 else f"noise_{idx - 1}"
            self.noises.register_buffer(name, torch.zeros(1, 1, h, w, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference init, drawn from ``generator`` (a CPU generator):
        weights ~N(0,1), style-affine biases 1, other biases and noise
        weights 0, constant inputs 1, noise buffers ~N(0,1)."""
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, EqualizedLinear):
                    module.reset_parameters(generator)
                elif isinstance(module, ModulatedConv2d):
                    module.weight.copy_(torch.randn(module.weight.shape, generator=generator))
                elif isinstance(module, (FusedLeakyReLU, NoiseInjection, OutputBlock)):
                    for p in module.parameters(recurse=False):
                        p.zero_()
                elif isinstance(module, ConstantInput):
                    module.input.fill_(1.0)
            for buf in self.noises.buffers():
                buf.copy_(torch.randn(buf.shape, generator=generator))

    # ---------------------------------------------------------------- noise

    def _noise_shapes(self) -> List[Tuple[int, int]]:
        cfg = self.config
        h0, w0 = cfg.starting_resolution
        shapes = [(h0, w0)]
        for i in range(cfg.n_stages):
            r = (h0 * 2 ** (i + 1), w0 * 2 ** (i + 1))
            shapes.extend([r, r])
        return shapes

    def fixed_noise(self) -> List[torch.Tensor]:
        """The registered [1, 1, H, W] noise buffers, in layer order."""
        return list(self.noises.buffers())

    def random_noise(self, batch: int, generator: torch.Generator) -> List[torch.Tensor]:
        """Fresh [batch, 1, H, W] N(0,1) noise per layer, on the generator's device."""
        return [
            torch.randn((batch, 1, h, w), generator=generator, device=generator.device)
            for h, w in self._noise_shapes()
        ]

    # ---------------------------------------------------------------- styles

    def map_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, D] -> w [B, D]."""
        return self.style_mapping(z)

    def make_wplus(self, w1: torch.Tensor, w2: torch.Tensor, inject_index) -> torch.Tensor:
        """w1 in the slots before ``inject_index``, w2 from it on
        (multi_stylegan_generator.py:151-160) -> [B, n_latents, D]."""
        slots = torch.arange(self.config.n_latents, device=w1.device)[None, :, None]
        return torch.where(slots < inject_index, w1[:, None, :], w2[:, None, :])

    # ------------------------------------------------------------- synthesis

    def _block(self, module: nn.Module, px: int, *args):
        """Run a block, rematerialized in the backward pass where the config
        asks for it (generator.py:184-195 of the JAX package)."""
        cfg = self.config
        if cfg.remat and px >= cfg.remat_min_px and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def synthesize(self, wplus: torch.Tensor, noise: Sequence[torch.Tensor],
                   return_latents: bool = False):
        """wplus [B, n_latents, D] + per-layer noise -> [B, domains, T, H, W]."""
        cfg = self.config
        b = wplus.shape[0]
        compat = cfg.compat_tower2_output_bug
        dtype = getattr(torch, cfg.compute_dtype)
        wplus = wplus.to(dtype)
        noise = [n.to(dtype) for n in noise]
        sc1, sc2 = self.starting_convolution_1, self.starting_convolution_2
        mc1, mc2 = self.main_convolutions_1, self.main_convolutions_2
        ob1, ob2 = self.output_blocks_1, self.output_blocks_2

        def const(ci):
            return ci.input.to(dtype).expand(b, -1, -1, -1).contiguous(memory_format=_CL)

        run = self._block
        px = cfg.starting_resolution[0]
        out1, s = run(sc1, px, const(self.constant_input_1), wplus[:, 0], noise[0])
        out2 = run(sc2, px, const(self.constant_input_2), s, noise[0])
        # The tower-2 quirk is only in the stage loop (reference line 189).
        skip1, s = run(self.starting_output_block_1, px, out1, wplus[:, 1])
        skip2 = run(self.starting_output_block_2, px, out2, s)
        for i in range(cfg.n_stages):
            px = cfg.starting_resolution[0] * 2 ** (i + 1)
            out1, s = run(mc1[2 * i], px, out1, wplus[:, 2 * i + 1], noise[2 * i + 1])
            out2 = run(mc2[2 * i], px, out2, s, noise[2 * i + 1])
            out1, s = run(mc1[2 * i + 1], px, out1, wplus[:, 2 * i + 2], noise[2 * i + 2])
            out2 = run(mc2[2 * i + 1], px, out2, s, noise[2 * i + 2])
            skip1, s = run(ob1[i], px, out1, wplus[:, 2 * i + 3], skip1)
            skip2 = run(ob2[i], px, out1 if compat else out2, s, skip2)
        image = torch.stack([skip1.float(), skip2.float()], dim=1).contiguous()
        if return_latents:
            return image, wplus
        return image

    def forward(
        self,
        z: torch.Tensor,
        z2: Optional[torch.Tensor] = None,
        *,
        input_is_latent: bool = False,
        inject_index: Optional[int] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        randomize_noise: bool = True,
        return_latents: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Convenience forward mirroring the reference signature
        (multi_stylegan_generator.py:114-205).  ``generator`` supplies the
        random inject index and noise where those are drawn here."""
        cfg = self.config
        if input_is_latent and z.dim() == 3:
            wplus = z
        else:
            w1 = z if input_is_latent else self.map_latent(z)
            if z2 is not None:
                w2 = z2 if input_is_latent else self.map_latent(z2)
                if inject_index is None:
                    inject_index = int(torch.randint(
                        1, cfg.n_latents - 1, (1,), generator=generator,
                        device=generator.device if generator is not None else "cpu"))
            else:
                w2 = w1
                inject_index = cfg.n_latents
            wplus = self.make_wplus(w1, w2, inject_index)
        if noise is None:
            if randomize_noise:
                if generator is None:
                    raise ValueError("randomize_noise needs a torch.Generator")
                noise = self.random_noise(z.shape[0], generator)
            else:
                noise = self.fixed_noise()
        return self.synthesize(wplus, noise, return_latents=return_latents)
