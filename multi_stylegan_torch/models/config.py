"""Generator config with the reference defaults (the port's own copy).

Mirrors ``GeneratorConfig`` / ``tiny_generator_config`` of the JAX package
field for field (reference multi_stylegan/config.py:16-27), so a config
built with the same keyword arguments describes the same network in both.
"""

from __future__ import annotations

import dataclasses
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
    num_domains: int = 2
    blur_taps: Tuple[int, ...] = (1, 3, 3, 1)
    # Reference quirk: the tower-2 output blocks consume tower-1 features
    # (multi_stylegan_generator.py:189).  True reproduces the published
    # checkpoint's behaviour; False is the symmetric wiring.
    compat_tower2_output_bug: bool = False
    # Activation compute dtype ("float32" or "bfloat16"); params stay fp32,
    # images are returned fp32.
    compute_dtype: str = "float32"
    # Training-only (activation rematerialization); kept so configs match
    # the JAX package's field for field, and ignored by inference.
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


def tiny_generator_config(**overrides) -> GeneratorConfig:
    """A 32x32 fixture config for tests and smoke runs."""
    kw = dict(
        channels=(32, 32, 32, 32),
        latent_dimensions=32,
        depth_style_mapping=2,
    )
    kw.update(overrides)
    return GeneratorConfig(**kw)
