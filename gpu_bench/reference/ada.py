"""Adaptive discriminator augmentation (ADA) in plain PyTorch, on the device.

Reference: multi_stylegan/adaptive_discriminator_augmentation.py, as the JAX
package's train/ada.py has it:

* the controller state (p, the r accumulator) is a set of device tensors,
  updated without a host sync (:class:`AdaState`, :func:`update_ada_state`);
* the pipeline (ada.py:108-200) is flip -> 90-degree rotation (one angle per
  batch, zeros padding) -> circular integer translation (one shift per
  batch, +-12.5%) -> one composed affine warp for iso scale, rotation, aniso
  scale and rotation (reflect padding), each stage gated per image; with
  ``sequential_warps`` the four stages are four separately gated warps, as
  the reference's kornia calls are (ada.py:613-630 of the JAX package),
  from the same draws;
* the random draws come from the caller (:class:`AdaDraws`), so the same
  draws give the same images as the JAX pipeline.

The bilinear resampler keeps the JAX conventions, which differ from
``F.grid_sample`` at the border: the centre is 0.5 x extent, reflect
indices mirror corner by corner about 0 and n-1 (align_corners style), and
zeros padding clips each corner's index and then masks it out.  It is a
gather, so autograd's adjoint is the exact scatter-add (a CUDA scatter-add
uses atomics: the images' gradient may differ in the last bits run to run).
Only first order is needed: R1 runs on un-augmented reals.  The resampler
computes in f32 whatever the images' dtype (a bf16 image times the f32
bilinear weights promotes), as the JAX gather does; the trainer's images
are f32 in any case (the generator returns f32, the discriminator casts).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpu_bench.reference import single as mesh

# std of the underlying normal for the log-normal scale jitter (ada.py:141)
LOGNORMAL_SIGMA = (0.2 * math.log(2.0)) ** 2


@dataclasses.dataclass
class AdaState:
    """Device-resident controller state (ada.py:36-39)."""

    p: torch.Tensor       # augmentation probability
    r_sum: torch.Tensor   # accumulated overfitting heuristic
    r_count: torch.Tensor  # fake batches accumulated
    last_r: torch.Tensor  # last r mean (for logging)

    @classmethod
    def create(cls, p_init: float = 0.05, device=None) -> "AdaState":
        f = dict(dtype=torch.float32, device=device)
        return cls(p=torch.tensor(p_init, **f), r_sum=torch.tensor(0.0, **f),
                   r_count=torch.tensor(0, dtype=torch.int32, device=device),
                   last_r=torch.tensor(0.0, **f))


def calc_r(prediction_scalar: torch.Tensor, prediction_pixel_wise: torch.Tensor) -> torch.Tensor:
    """r = 0.5 E[sign(D_s)] + 0.5 E[sign(mean D_p)] on FAKE batches
    (ada.py:43-52; the reference signs the fake predictions, a quirk kept);
    over the global batch under data parallelism, so p moves the same way
    on every rank."""
    r1, r2 = mesh.global_mean(torch.sign(prediction_scalar),
                              torch.sign(prediction_pixel_wise.mean(dim=(-1, -2))))
    return 0.5 * r1 + 0.5 * r2


@torch.no_grad()
def update_ada_state(state: AdaState, r_value: torch.Tensor, *, r_target: float = 0.6,
                     p_step: float = 5e-3, r_update: int = 8, p_max: float = 0.8) -> AdaState:
    """Accumulate r; every ``r_update`` fake batches step p towards keeping r
    at ``r_target`` and clamp to [0, p_max] (ada.py:80-95).  A non-finite r
    is replaced by the last mean rather than accumulated: p drives every
    later batch's augmentation."""
    r_value = torch.where(torch.isfinite(r_value), r_value, state.last_r)
    r_sum = state.r_sum + r_value
    r_count = state.r_count + 1
    trigger = r_count >= r_update
    r_mean = r_sum / torch.clamp(r_count, min=1).float()
    p_new = torch.where(r_mean > r_target, state.p + p_step, state.p - p_step)
    p_new = torch.clamp(p_new, 0.0, p_max)
    return AdaState(
        p=torch.where(trigger, p_new, state.p),
        r_sum=torch.where(trigger, torch.zeros_like(r_sum), r_sum),
        r_count=torch.where(trigger, torch.zeros_like(r_count), r_count),
        last_r=torch.where(trigger, r_mean, state.last_r),
    )


# ---------------------------------------------------------------------------
# the bilinear resampler
# ---------------------------------------------------------------------------


def _reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect indices into [0, n-1] about 0 and n-1 without repeating the
    edge sample (align_corners style)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m > n - 1, period - m, m)


def _bilinear_gather(images: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                     padding: str) -> torch.Tensor:
    """Sample NCHW ``images`` at float source coords sx/sy [B, H, W]."""
    b, c, h, w = images.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    tx = (sx - x0)[:, None]
    ty = (sy - y0)[:, None]
    flat = images.reshape(b, c, h * w)

    def gather(yi, xi):
        if padding == "reflect":
            yc = _reflect_index(yi, h).long()
            xc = _reflect_index(xi, w).long()
        else:
            yc = torch.clamp(yi, 0, h - 1).long()
            xc = torch.clamp(xi, 0, w - 1).long()
        lin = (yc * w + xc).reshape(b, 1, h * w).expand(b, c, h * w)
        vals = flat.gather(2, lin).reshape(b, c, h, w)
        if padding == "zeros":
            inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            vals = vals * inb[:, None].to(vals.dtype)
        return vals

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty


def rot_mat(angle_deg: torch.Tensor) -> torch.Tensor:
    """[B, 2, 2] rotation matrices (x, y) for per-image angles in degrees."""
    theta = torch.deg2rad(angle_deg.float())
    cos, sin = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)


def scale_mat(scale_xy: torch.Tensor) -> torch.Tensor:
    """[B, 2, 2] diagonal scale matrices from [B, 2] (x, y) factors."""
    z = torch.zeros_like(scale_xy[:, 0])
    return torch.stack([torch.stack([scale_xy[:, 0], z], -1),
                        torch.stack([z, scale_xy[:, 1]], -1)], -2)


def apply_affine_matrix(images: torch.Tensor, inv_mat: torch.Tensor,
                        padding: str = "reflect") -> torch.Tensor:
    """Warp NCHW ``images`` by per-image 2x2 *inverse* maps about the image
    centre (0.5 x extent, ada.py:137-138): src = c + inv_mat @ (dst - c),
    bilinear sampling.  Differentiable w.r.t. ``images``."""
    if padding not in ("reflect", "zeros"):
        raise ValueError(f"padding must be 'reflect' or 'zeros', got {padding!r}")
    b, _, h, w = images.shape
    cy, cx = 0.5 * h, 0.5 * w
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=images.device),
                            torch.arange(w, dtype=torch.float32, device=images.device),
                            indexing="ij")
    dx, dy = (xs - cx)[None], (ys - cy)[None]
    m = inv_mat.float()[:, :, :, None, None]
    sx = cx + m[:, 0, 0] * dx + m[:, 0, 1] * dy
    sy = cy + m[:, 1, 0] * dx + m[:, 1, 1] * dy
    return _bilinear_gather(images, sx, sy, padding)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdaDraws:
    """The random draws of one pipeline call (ada.py:108-200), in JAX's key
    order: per-image gates are bool [B]; ``rot90_index`` picks the batch's
    angle from (0, -90, 90, 180); ``shift`` is the batch's (rows, cols)
    roll; ``s_iso`` [B, 1] and ``s_aniso`` [B, 2] are the log-normal scales;
    ``angle`` / ``angle2`` [B] in degrees."""

    flip: torch.Tensor
    rot90_index: torch.Tensor
    rot90: torch.Tensor
    shift: torch.Tensor
    translate: torch.Tensor
    s_iso: torch.Tensor
    iso: torch.Tensor
    angle: torch.Tensor
    rot1: torch.Tensor
    s_aniso: torch.Tensor
    aniso: torch.Tensor
    angle2: torch.Tensor
    rot2: torch.Tensor


def _roll(images: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Circular roll of H and W by device-tensor shifts (torch.roll needs
    host ints): out[i] = x[(i - s) mod n]."""
    _, _, h, w = images.shape
    rows = torch.remainder(torch.arange(h, device=images.device) - shift[0], h)
    cols = torch.remainder(torch.arange(w, device=images.device) - shift[1], w)
    return images.index_select(2, rows).index_select(3, cols)


def augmentation_pipeline(images: torch.Tensor, draws: AdaDraws,
                          sequential_warps: bool = False) -> torch.Tensor:
    """The ADA pipeline on NCHW images [B, C*T, H, W] with the given draws
    (ada.py:553-637 of the JAX package): the four affine stages composed
    into one warp, or with ``sequential_warps`` warped one after another."""
    b = images.shape[0]

    def gate(mask, augmented, current):
        return torch.where(mask[:, None, None, None], augmented, current)

    images = gate(draws.flip, images.flip(3), images)
    angles = torch.tensor([0.0, -90.0, 90.0, 180.0], device=images.device)
    angle = angles[draws.rot90_index].expand(b)
    ones = torch.ones((b, 2), device=images.device)
    rotated = apply_affine_matrix(images, scale_mat(1.0 / ones) @ rot_mat(-angle), "zeros")
    images = gate(draws.rot90, rotated, images)
    images = gate(draws.translate, _roll(images, draws.shift), images)

    if sequential_warps:
        zero = torch.zeros(b, device=images.device)
        for mask, angle, scale in ((draws.iso, zero, draws.s_iso.repeat(1, 2)),
                                   (draws.rot1, draws.angle, ones),
                                   (draws.aniso, zero, draws.s_aniso),
                                   (draws.rot2, draws.angle2, ones)):
            inv = scale_mat(1.0 / scale) @ rot_mat(-angle)
            images = gate(mask, apply_affine_matrix(images, inv, "reflect"), images)
        return images

    eye = torch.eye(2, device=images.device).expand(b, 2, 2)

    def gated(mask, mat):
        return torch.where(mask[:, None, None], mat, eye)

    inv = (gated(draws.iso, scale_mat(1.0 / draws.s_iso.repeat(1, 2)))
           @ gated(draws.rot1, rot_mat(-draws.angle))
           @ gated(draws.aniso, scale_mat(1.0 / draws.s_aniso))
           @ gated(draws.rot2, rot_mat(-draws.angle2)))
    return apply_affine_matrix(images, inv, "reflect")


def augment_sequences(images: torch.Tensor, draws: AdaDraws,
                      sequential_warps: bool = False) -> torch.Tensor:
    """ADA entry point for [B, C, T, H, W] sequences: flatten channel*time,
    augment, restore (ada.py:66-72)."""
    b, c, t, h, w = images.shape
    flat = augmentation_pipeline(images.reshape(b, c * t, h, w), draws, sequential_warps)
    return flat.reshape(b, c, t, h, w)
