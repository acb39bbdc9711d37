"""Model and training configs with the reference defaults (the port's own copy).

Mirrors ``GeneratorConfig``, ``DiscriminatorConfig``, ``TrainingConfig`` and
the ``tiny_*`` factories of the JAX package field for field (reference
multi_stylegan/config.py:6-57 and train_multi_stylegan.py:4-28), so a config
built with the same keyword arguments describes the same network and run in
both.  ``GeneratorConfig`` has three fields more, whose defaults are the
JAX package's network: ``up_kernel_size``, ``skip_upsample_gain`` and
``rgb_bias_per_channel`` build StyleGAN2's generator (config F, one tower
through ``num_domains``), which the JAX package does not have.  The
models' ``compute_dtype`` is what the trainer's D, cut-mix and G steps run
in (R1 and path length always run in f32);
``TrainingConfig.ada_sequential_warps`` picks ADA's four sequential warps
over the composed one.  ``TrainingConfig.compute_dtype`` is kept for that
equality and read by nothing: the CLI sets the models' dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Dual-tower StyleGAN2 generator config (reference config.py:16-27)."""

    channels: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    channel_factor: float = 1
    latent_dimensions: int = 512
    depth_style_mapping: int = 8
    starting_resolution: Tuple[int, int] = (4, 4)
    # Frames generated per domain (multi_stylegan_generator.py:30).
    sequence_length: int = 3
    # Number of imaging domains (towers); the reference hard-codes 2 (BF+GFP).
    # Tower 1 owns the style affines; StyleGAN2 is one tower of T = 3 (RGB).
    num_domains: int = 2
    blur_taps: Tuple[int, ...] = (1, 3, 3, 1)
    # The upsampling conv's kernel: Multi-StyleGAN's k2 s2 transposed conv,
    # whose windows never overlap, or StyleGAN2's k3 s2 (config F).
    up_kernel_size: int = 2
    # Gain of the output blocks' skip upsample: 1 is Multi-StyleGAN's plain
    # normalized kernel, 4 (factor**2) StyleGAN2's upfirdn2d(up=2).
    skip_upsample_gain: float = 1.0
    # The output blocks' bias: one scalar (Multi-StyleGAN) or one per
    # output channel (StyleGAN2's toRGB, [1, T, 1, 1]).
    rgb_bias_per_channel: bool = False
    # Reference quirk: the tower-2 output blocks consume tower-1 features
    # (multi_stylegan_generator.py:189).  True reproduces the published
    # checkpoint's behaviour; False is the symmetric wiring.
    compat_tower2_output_bug: bool = False
    # Activation compute dtype ("float32" or "bfloat16"); params stay fp32,
    # images are returned fp32.
    compute_dtype: str = "float32"
    # Rematerialize styled-conv and output blocks in the backward pass
    # (torch.utils.checkpoint), only blocks at >= remat_min_px pixels
    # (0 = every block).  Inference ignores it.
    remat: bool = True
    remat_min_px: int = 0

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(int(c // self.channel_factor) for c in self.channels)

    @property
    def n_stages(self) -> int:
        """Number of upsampling stages (6 for the 4->256 default)."""
        return len(self.channels) - 1

    @property
    def n_latents(self) -> int:
        """Per-layer w slots: 2*(len(channels)-1) + 2 = 14 by default."""
        return 2 * self.n_stages + 2

    @property
    def resolution(self) -> Tuple[int, int]:
        r = 2 ** self.n_stages
        return (self.starting_resolution[0] * r, self.starting_resolution[1] * r)


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """U-Net discriminator config (reference config.py:6-13)."""

    encoder_channels: Tuple[Tuple[int, int], ...] = (
        (3, 128), (128, 256), (256, 384), (384, 768), (768, 1024),
    )
    decoder_channels: Tuple[Tuple[int, int], ...] = (
        (1024, 768), (768, 384), (384, 256), (256, 128),
    )
    fft: bool = False
    no_rfp: bool = True
    no_gfp: bool = False
    sequence_length: int = 3
    # Activation compute dtype ("float32" or "bfloat16"); params stay fp32,
    # heads are returned fp32.
    compute_dtype: str = "float32"
    # Rematerialize encoder/decoder blocks in the backward pass.
    remat: bool = True
    remat_min_px: int = 0

    @property
    def input_channels(self) -> int:
        """Flattened channel*time input width (u_net_2d_discriminator.py:35-50)."""
        if self.no_gfp:
            return self.sequence_length
        if self.no_rfp:
            return 2 * self.sequence_length
        return 3 * self.sequence_length


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """Training hyperparameters (reference config.py:30-57 +
    train_multi_stylegan.py:4-28 argparse defaults)."""

    batch_size: int = 24
    epochs: int = 100
    lr_generator: float = 2e-4
    lr_discriminator: float = 6e-4
    # The style-mapping net trains at lr/100 (train_multi_stylegan.py:53-55).
    lr_style_factor: float = 0.01
    adam_beta1: float = 0.0
    adam_beta2: float = 0.999
    grad_clip_norm: float = 5.0
    # Skip parameter updates containing non-finite values (train/state.py).
    skip_nonfinite_updates: bool = True
    max_consecutive_nonfinite: int = 100
    ema_decay: float = 0.999
    p_mixed_noise: float = 0.9
    lazy_generator_regularization: int = 16
    w_generator_regularization: float = math.log(2) / ((256 ** 2) * (math.log(256) - math.log(2)))
    lazy_discriminator_regularization: int = 16
    w_discriminator_regularization_r1: float = 10.0
    w_discriminator_regularization: float = 4.0
    batch_factor_wrong_order: float = 0.25
    batch_size_shrink_path_length_regularization: float = 0.5
    top_k: bool = True
    top_k_start: float = 0.25
    top_k_finish: float = 0.75
    wrong_order_start: float = 0.75
    trap_weight_start: float = 0.25
    path_length_decay: float = 0.01
    # ADA controller (reference adaptive_discriminator_augmentation.py:18-41)
    ada: bool = True
    ada_r_target: float = 0.6
    ada_p_step: float = 5e-3
    ada_r_update: int = 8
    ada_p_max: float = 0.8
    ada_p_init: float = 0.05
    ada_sequential_warps: bool = False
    compute_dtype: str = "bfloat16"
    validate_every_n_epochs: int = 10
    checkpoint_every_n_epochs: int = 5
    resume_training: bool = False
    seed: int = 0


def tiny_generator_config(**overrides) -> GeneratorConfig:
    """A 32x32 fixture config for tests and smoke runs."""
    kw = dict(
        channels=(32, 32, 32, 32),
        latent_dimensions=32,
        depth_style_mapping=2,
    )
    kw.update(overrides)
    return GeneratorConfig(**kw)


def tiny_discriminator_config(**overrides) -> DiscriminatorConfig:
    """The discriminator matching the 32x32 fixture config."""
    kw = dict(
        encoder_channels=((3, 16), (16, 24), (24, 32), (32, 48)),
        decoder_channels=((48, 32), (32, 24), (24, 16)),
    )
    kw.update(overrides)
    return DiscriminatorConfig(**kw)
