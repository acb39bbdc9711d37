"""Latent-noise and permutation helpers (reference multi_stylegan/misc.py:202-252).

As in the JAX package's train/noise.py, ``get_noise`` always returns two
latents plus a "use mixing" flag (the reference returns one or two tensors
after a host coin flip), so the caller never branches on the host.  Draws
come from a ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def get_noise(generator: torch.Generator, batch_size: int, latent_dimension: int,
              p_mixed_noise: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z1 [B, D], z2 [B, D], use_mixing 0-d bool) on the generator's device."""
    dev = generator.device
    z1 = torch.randn((batch_size, latent_dimension), generator=generator, device=dev)
    z2 = torch.randn((batch_size, latent_dimension), generator=generator, device=dev)
    coin = torch.rand((), generator=generator, device=dev)
    use_mixing = coin < p_mixed_noise if p_mixed_noise > 0 else torch.zeros((), dtype=torch.bool, device=dev)
    return z1, z2, use_mixing


def random_permutation(generator: torch.Generator, n: int) -> torch.Tensor:
    """Random index sequence avoiding the identity (misc.py:202-213).

    The reference quirk is kept: indices are drawn WITH replacement
    (``np.random.choice``'s default), so repeats happen; a draw equal to the
    identity becomes the reversed sequence."""
    dev = generator.device
    perm = torch.randint(0, n, (n,), generator=generator, device=dev)
    ident = torch.arange(n, device=dev)
    return torch.where((perm == ident).all(), ident.flip(0), perm)
