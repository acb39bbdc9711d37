"""Dual-tower Multi-StyleGAN generator (PyTorch, NCHW: planar or channels_last).

Architecture: reference multi_stylegan/multi_stylegan_generator.py and the
JAX package's models/generator.py.  Tower-1 blocks own the style affine and
return the modulated style ``s``, which the matching block of every other
tower consumes directly, so all imaging domains share one style trajectory.
With ``num_domains=1``, a k3 up-conv, the skip upsample's gain of 4 and a
toRGB bias per channel the same module is StyleGAN2's generator (config F:
``GeneratorConfig`` notes the fields).

Port decisions:
* activations are NCHW tensors in one of two layouts, chosen once a call by
  :func:`layout`: planar (NCHW-contiguous) for f32 with autograd off, where
  cuDNN's f32 convolutions are NCHW kernels, and ``torch.channels_last``
  otherwise, where the bf16 convolutions are NHWC kernels and the gradient
  kernels (K2, K4) take only NHWC.  Either way ``x.permute(0, 2, 3, 1)`` is
  a (B, H, W, C)-ordered view that goes to the kernels (fused leaky-ReLU,
  upfirdn2d) with no copy, and they tell the layouts apart by its strides;
* per-sample modulated weights never exist (ops/modulated_conv.py);
* state-dict keys and shapes are the reference's, exactly what the JAX
  package's ``export_generator`` emits, so a reference checkpoint's
  ``generator_ema`` loads with ``load_state_dict(strict=True)``;
* the images are ``[B, domains, T, H, W]`` in f32 whatever the compute dtype;
  ``synthesize`` takes a per-call compute dtype and remat, so the trainer's
  f32 regularisers run the same module and ``Parameter``s as its bf16 steps;
* with ``config.remat`` and gradients on, each styled-conv and output block
  at >= ``remat_min_px`` pixels is recomputed in the backward pass
  (``torch.utils.checkpoint``, non-reentrant, so path length's double
  backward goes through it), as the JAX package's ``nn.remat`` blocks are.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multi_stylegan_torch.models.config import GeneratorConfig
from multi_stylegan_torch.nn.equalized import EqualizedLinear, FusedLeakyReLU
from multi_stylegan_torch.nn.layout import FORMATS, layout
from multi_stylegan_torch.nn.normalization import pixel_norm
from multi_stylegan_torch.ops.blur import Blur, blur, up_blur_padding, upsample2x
from multi_stylegan_torch.ops.modulated_conv import (
    modulated_conv2d,
    modulated_conv_transpose2d,
)
from multi_stylegan_torch.parallel import tensor as tp
from multi_stylegan_torch.utils.profiling import span

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The (B, H, W, C)-ordered view of ``x`` in its call's layout."""
    return x.contiguous(memory_format=FORMATS[layout(x.dtype)]).permute(0, 2, 3, 1)


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
    The upsampling variant is a k s2 transposed conv (k2 for Multi-StyleGAN,
    k3 for StyleGAN2) followed by the gain-4 blur with
    ``up_blur_padding(len(taps), k)``, which makes the output 2H.  Under
    tensor parallelism (parallel/tensor.py) the weight may hold this rank's
    output channels: modulation and demodulation are local to them, and a
    gather makes the full output before the blur.
    """

    tp_param = ("weight", 1)
    tp_sharded = False

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
            self.blur_pad = up_blur_padding(len(blur_taps), k)

    def forward(self, x: torch.Tensor, style: torch.Tensor):
        s = self.modulation_mapping(style) if self.has_mapping else style
        w = self.weight[0]
        xl, sl = (tp.copy(x), tp.copy(s)) if self.tp_sharded else (x, s)
        if self.upsampling:
            y = modulated_conv_transpose2d(
                xl, w, sl, scale=self.scale, demodulate=self.demodulate, stride=2)
        else:
            y = modulated_conv2d(xl, w, sl, scale=self.scale, demodulate=self.demodulate,
                                 padding=self.kernel_size // 2)
        if self.tp_sharded:
            y = tp.gather(y)
        if self.upsampling:
            y = _nchw(blur(_nhwc(y), self.blur.kernel, self.blur_pad))
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
    """k1 non-demodulated modulated conv + bias + blur-upsampled skip
    (multi_stylegan_generator.py:472-526).  Multi-StyleGAN: one scalar bias
    and a skip upsample of gain 1; StyleGAN2's toRGB: a bias per output
    channel and gain 4 (``bias_per_channel``, ``skip_gain``)."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 upsampling: bool, modulation_mapping: bool,
                 blur_taps: Tuple[int, ...], skip_gain: float = 1.0,
                 bias_per_channel: bool = False, device=None):
        super().__init__()
        self.has_mapping = modulation_mapping
        self.has_upsampling = upsampling
        self.bias = nn.Parameter(torch.zeros(
            1, out_channels if bias_per_channel else 1, 1, 1, device=device))
        self.modulated_convolution = ModulatedConv2d(
            in_channels, out_channels, 1, style_dim, demodulate=False,
            upsampling=False, modulation_mapping=modulation_mapping, device=device)
        if upsampling:
            # the reference's Upsample: the plain normalized kernel, no
            # factor**2 gain (skip_gain 1); StyleGAN2's Upsample has it (4)
            self.upsampling = Blur(blur_taps, gain=skip_gain, device=device)

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
    tp_param = ("input", 1)
    tp_sharded = False

    def __init__(self, channels: int, size: Tuple[int, int], device=None):
        super().__init__()
        self.input = nn.Parameter(torch.ones(1, channels, *size, device=device))

    def value(self) -> torch.Tensor:
        """The [1, C, h, w] input (gathered when this rank holds a block)."""
        return tp.gather(self.input) if self.tp_sharded else self.input


class Generator(nn.Module):
    """Synthesis network of ``num_domains`` towers (Multi-StyleGAN: 2).
    Output: [B, num_domains, T, H, W] f32."""

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
        rgb = dict(skip_gain=cfg.skip_upsample_gain, bias_per_channel=cfg.rgb_bias_per_channel,
                   device=device)
        for tower in range(1, cfg.num_domains + 1):
            mm = tower == 1
            setattr(self, f"constant_input_{tower}", ConstantInput(ch[0], (h0, w0), device))
            setattr(self, f"starting_convolution_{tower}", StyledConv2d(
                ch[0], ch[0], 3, d, False, mm, taps, device))
            setattr(self, f"starting_output_block_{tower}", OutputBlock(
                ch[0], t, d, False, mm, taps, **rgb))
            convs, outs = nn.ModuleList(), nn.ModuleList()
            for i in range(cfg.n_stages):
                convs.append(StyledConv2d(ch[i], ch[i + 1], cfg.up_kernel_size, d, True, mm,
                                          taps, device))
                convs.append(StyledConv2d(ch[i + 1], ch[i + 1], 3, d, False, mm, taps, device))
                outs.append(OutputBlock(ch[i + 1], t, d, True, mm, taps, **rgb))
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

    def _block(self, remat: bool, module: nn.Module, px: int, *args):
        """Run a block, rematerialized in the backward pass where ``remat``
        and the config's ``remat_min_px`` ask for it (generator.py:184-195
        of the JAX package)."""
        if remat and px >= self.config.remat_min_px and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def synthesize(self, wplus: torch.Tensor, noise: Sequence[torch.Tensor],
                   return_latents: bool = False, *, compute_dtype: Optional[str] = None,
                   remat: Optional[bool] = None):
        """wplus [B, n_latents, D] + per-layer noise -> [B, domains, T, H, W].
        ``compute_dtype`` / ``remat`` override the config's for this call.
        Each resolution's blocks of every tower run inside a ``g.stage``
        span with its ``px`` and the call's :func:`layout`."""
        cfg = self.config
        b = wplus.shape[0]
        compat = cfg.compat_tower2_output_bug
        dtype = getattr(torch, compute_dtype or cfg.compute_dtype)
        lay = layout(dtype)
        wplus = wplus.to(dtype)
        noise = [n.to(dtype) for n in noise]
        towers = range(1, cfg.num_domains + 1)

        def blocks(name):
            return [getattr(self, f"{name}_{t}") for t in towers]

        def const(ci):
            return ci.value().to(dtype).expand(b, -1, -1, -1).contiguous(
                memory_format=FORMATS[lay])

        run = functools.partial(self._block, cfg.remat if remat is None else remat)

        def layer(modules, px, xs, w, args, out):
            """One block of every tower, tower t's result written to ``out[t]``
            as it arrives (so the value it replaces is released, as a lone
            tower's loop releases it); tower 1's maps ``w`` to the style the
            others take."""
            out[0], s = run(modules[0], px, xs[0], w, *args[0])
            for t in range(1, len(modules)):
                out[t] = run(modules[t], px, xs[t], s, *args[t])

        n = cfg.num_domains
        px = cfg.starting_resolution[0]
        with span("g.stage", px=px, layout=lay):
            outs = [const(ci) for ci in blocks("constant_input")]
            layer(blocks("starting_convolution"), px, outs, wplus[:, 0], [(noise[0],)] * n, outs)
            # The tower-2 quirk is only in the stage loop (reference line 189).
            skips = [None] * n
            layer(blocks("starting_output_block"), px, outs, wplus[:, 1], [()] * n, skips)
        mc, ob = blocks("main_convolutions"), blocks("output_blocks")
        for i in range(cfg.n_stages):
            px = cfg.starting_resolution[0] * 2 ** (i + 1)
            with span("g.stage", px=px, layout=lay):
                for j in (2 * i, 2 * i + 1):
                    layer([m[j] for m in mc], px, outs, wplus[:, j + 1], [(noise[j + 1],)] * n,
                          outs)
                feats = [outs[0]] * n if compat else outs
                layer([o[i] for o in ob], px, feats, wplus[:, 2 * i + 3],
                      [(skip,) for skip in skips], skips)
        image = torch.stack([skip.float() for skip in skips], dim=1).contiguous()
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
        with span("g.forward", layout=layout(getattr(torch, cfg.compute_dtype))):
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
