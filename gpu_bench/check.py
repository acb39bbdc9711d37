"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference works out again from the same
inputs, each held against its limit (``limits/<cell>.json``)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

from gpu_bench.bench import BENCH, load_json

# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: it is left out of the leaf gaps.
QUIET_LEAF = 1e-3


def limits(cell: str) -> Dict[str, float]:
    return load_json(BENCH / "limits" / f"{cell}.json")["limits"]


def loss_gap(program: Sequence[Dict[str, float]], reference: Sequence[Dict[str, float]]) -> float:
    """The widest gap of a step's loss, over the steps and the losses, as a
    share of the reference's value or of the median value of that step's
    losses, whichever is larger."""
    worst = 0.0
    for p, r in zip(program, reference, strict=True):
        keys = sorted(k for k in r if k.startswith("loss") or k == "path_length")
        floor = statistics.median(abs(r[k]) for k in keys)
        for k in keys:
            worst = max(worst, abs(p[k] - r[k]) / max(abs(r[k]), floor, 1e-30))
    return worst


def quiet(reference_grads: Sequence[float]) -> List[bool]:
    """Which leaves count: those whose reference gradient is at least
    ``QUIET_LEAF`` of the median leaf's."""
    med = statistics.median(reference_grads)
    return [g >= QUIET_LEAF * med for g in reference_grads]


def leaf_gaps(program: Sequence[float], reference: Sequence[float],
              keep: Sequence[bool]) -> List[float]:
    """Each kept leaf's gap between the two sides' norms, as a share of the
    reference's norm of that leaf or of the median leaf, whichever is larger."""
    kept = [(p, r) for p, r, k in zip(program, reference, keep, strict=True) if k]
    med = statistics.median(r for _, r in kept)
    return [abs(p - r) / max(r, med, 1e-30) for p, r in kept]


def leaf_gap(program: Sequence[float], reference: Sequence[float],
             keep: Sequence[bool]) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(program, reference, keep))


def verdict(numbers: Dict[str, float], cell: str) -> tuple:
    """(correct, [[name, number, limit], ...]) against the cell's limits; a
    number that is not finite fails."""
    lim = limits(cell)
    rows = [[k, numbers[k], lim[k]] for k in sorted(lim)]
    ok = all(v == v and v <= l for _, v, l in rows)  # NaN fails
    return ok, rows
