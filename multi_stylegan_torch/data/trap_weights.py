"""Trap-region pixel-weight map (the port's copy of the JAX package's
data/trap_weights.py, same numbers).

The reference's pixel losses accept a [H, W] weight map (reference
multi_stylegan/loss.py:124-128, model_wrapper.py:290-291, 405-406) but the
reference never builds one.  This function up-weights the microfluidic trap,
roughly centred in the field of view, with a cosine taper, and normalises
the map to mean 1 so that the pixel losses keep their overall scale.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_trap_weights_map(
    resolution: Tuple[int, int] = (256, 256),
    center: Optional[Tuple[float, float]] = None,
    trap_fraction: float = 0.5,
    inside_weight: float = 2.0,
    outside_weight: float = 1.0,
    taper_fraction: float = 0.25,
) -> np.ndarray:
    """[H, W] float32 map, mean exactly 1: ``inside_weight`` within a box of
    half-extent ``trap_fraction`` x min(H, W)/2 around ``center`` (default the
    image centre, (y, x) in pixels), ``outside_weight`` beyond a cosine ramp
    of width ``taper_fraction`` x min(H, W)/2, before normalisation."""
    if not 0.0 < trap_fraction <= 1.0:
        raise ValueError(f"trap_fraction must be in (0, 1], got {trap_fraction}")
    if inside_weight <= 0 or outside_weight <= 0:
        raise ValueError("weights must be positive")
    h, w = resolution
    cy, cx = center if center is not None else ((h - 1) / 2.0, (w - 1) / 2.0)
    half = min(h, w) / 2.0
    r_in = trap_fraction * half
    ramp = max(taper_fraction * half, 1e-6)

    yy = np.abs(np.arange(h, dtype=np.float32) - cy)
    xx = np.abs(np.arange(w, dtype=np.float32) - cx)
    # Chebyshev (box) distance from the trap box edge, in pixels
    d = np.maximum(yy[:, None], xx[None, :]) - r_in
    t = np.clip(d / ramp, 0.0, 1.0)
    blend = 0.5 * (1.0 + np.cos(np.pi * t))
    weights = (outside_weight + (inside_weight - outside_weight) * blend).astype(np.float32)
    return weights / weights.mean()
