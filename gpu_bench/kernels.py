"""The port's hand-written kernels as the benchmark sees them: their names in
a device trace, a census of their launches by call site, and the least time
each launch could take (a frozen copy of ``chip_smoke.py``'s census and
``bound_ms`` arithmetic).

A launch's least time is the larger of its bytes (every input read once,
every output written once) over the card's HBM bandwidth and its operations
over the f32 rate outside the tensor cores, which is what these
elementwise and stencil kernels use.  A kernel's roofline share is the sum of
its launches' least times over its device time in the trace.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Tuple

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Substrings of the kernels' names in a torch.profiler trace: K1 is the
# Triton kernel ``flr_fwd`` (ops/fused_act.py), K2 ``flr_grad_kernel``
# (csrc/fused_act.cu); K3 and K4 are one source, csrc/upfirdn2d.cu, in a
# general and a tiled form.
NAMES = {
    "fused_act": ("flr_fwd", "flr_grad_kernel"),
    "upfirdn2d": ("upfirdn2d_nhwc_kernel", "upfirdn2d_tiled_kernel"),
}
# The census kinds of each op.
KINDS = {"fused_act": ("K1", "K2"), "upfirdn2d": ("K3", "K4")}
ITEMSIZE = {"torch.float32": 4, "torch.bfloat16": 2, "torch.float16": 2}


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def out_size(n: int, up: int, down: int, pad0: int, pad1: int, k: int) -> int:
    return (n * up + pad0 + pad1 - k) // down + 1


def taps_used(n_in: int, n_out: int, up: int, down: int, pad0: int, k: int) -> int:
    """Sum over output positions of the taps that land on a real input sample."""
    used = 0
    for o in range(n_out):
        u0 = o * down - pad0
        used += sum(1 for t in range(k) if (u0 + t) >= 0 and (u0 + t) % up == 0
                    and (u0 + t) // up < n_in)
    return used


def launch_bound_s(key: Tuple) -> float:
    """The least time of one launch of a census key."""
    kind, shape, dtype = key[0], key[1], key[2]
    size = ITEMSIZE[dtype]
    if kind in ("K1", "K2"):
        c, m = shape[-1], math.prod(shape[:-1])
        reads = 1 if kind == "K1" else 2  # K1: x; K2: g and out (and an f32 [C])
        return bound_s((reads + 1) * m * c * size + c * 4, 4 * m * c)
    up, down, pad, (kh, kw) = key[3], key[4], key[5], key[6]
    b, h, w, c = shape
    ho, wo = out_size(h, up, down, pad[0], pad[1], kh), out_size(w, up, down, pad[2], pad[3], kw)
    used = taps_used(h, ho, up, down, pad[0], kh) * taps_used(w, wo, up, down, pad[2], kw)
    return bound_s((b * h * w * c + b * ho * wo * c) * size + kh * kw * 4, 2 * used * b * c)


def bound_by_op(sites: Dict[Tuple, int]) -> Dict[str, float]:
    """The least time of each op's launches in a census, in seconds."""
    out = {op: 0.0 for op in KINDS}
    for key, n in sites.items():
        op = next(o for o, kinds in KINDS.items() if key[0] in kinds)
        out[op] += n * launch_bound_s(key)
    return out


class Census:
    """Counts the kernels' launches by call site while it is entered, by
    wrapping the ops' device dispatchers (``fused_act._forward`` / ``_grad``,
    ``upfirdn2d._upfirdn``); a call on zero rows launches nothing and is not
    counted.  The ops' own launch counters are left alone."""

    def __init__(self):
        self.sites: Dict[Tuple, int] = collections.Counter()

    def __enter__(self):
        from multi_stylegan_torch.ops import fused_act, upfirdn2d

        self._mods = (fused_act, upfirdn2d)
        self._orig = (fused_act._forward, fused_act._grad, upfirdn2d._upfirdn)
        f1, f2, f3 = self._orig
        sites = self.sites

        def k1(x, bias, negative_slope, scale):
            if x.shape[0]:
                sites[("K1", tuple(x.shape), str(x.dtype))] += 1
            return f1(x, bias, negative_slope, scale)

        def k2(g, out, negative_slope, scale, addend=None, need_db=True):
            if g.shape[0]:
                sites[("K2", tuple(g.shape), str(g.dtype))] += 1
            return f2(g, out, negative_slope, scale, addend, need_db)

        def k3(x, kernel, up, down, pad, adjoint=False):
            if x.shape[0]:
                sites[("K4" if adjoint else "K3", tuple(x.shape), str(x.dtype), up, down,
                       tuple(pad), tuple(kernel.shape))] += 1
            return f3(x, kernel, up, down, pad, adjoint)

        fused_act._forward, fused_act._grad, upfirdn2d._upfirdn = k1, k2, k3
        return self

    def __exit__(self, *exc):
        fused_act, upfirdn2d = self._mods
        fused_act._forward, fused_act._grad, upfirdn2d._upfirdn = self._orig

    def launches(self) -> Dict[str, int]:
        out = collections.Counter()
        for key, n in self.sites.items():
            out[key[0]] += n
        return dict(out)


def launch_counters() -> Dict[str, int]:
    """The ops' own counters of launches on the card."""
    from multi_stylegan_torch.ops import fused_act, upfirdn2d

    return {"K1": fused_act.launches, "K2": fused_act.grad_launches,
            "K3": upfirdn2d.launches, "K4": upfirdn2d.grad_launches}
