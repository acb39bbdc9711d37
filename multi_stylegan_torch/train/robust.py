"""The path-length update's out-of-memory ladder (the JAX package's
train/robust.py and the Trainer's ``_robust_pl_step``, loop.py:77-110).

The path-length update is the iteration's largest second-order pass (f32
synthesis with a double backward).  :class:`RobustPathLength` runs it as
:meth:`TrainStep.path_length_grads` then :meth:`TrainStep.path_length_apply`
and, when the grads stage raises ``torch.cuda.OutOfMemoryError``, retries
the same update with the batch in more chunks: the unchunked split form
first, then each of :func:`pl_chunk_tiers`.  Only the grads stage is
guarded: it leaves the state as it was, so a retry starts clean, and its
draws were made once before the first try, so every tier computes the same
update.  A tier that ran stays the active one for later updates.

When every tier has failed, the update is skipped with a warning, from then
on, as the JAX Trainer does (it never moves to the CPU).  The state then
stays as it was: the G parameters, the running mean and the EMA, which the
main step left to this update (the JAX Trainer's skipped step returns its
state unchanged, robust.py:183-186, after a main step without the EMA,
loop.py:359).  The step's metrics say which tier ran
(``path_length_chunks``, the chunk count; 0 when none ran) and whether the
due update was skipped (``path_length_skipped``); a tier change is printed.
The JAX ladder's compile-helper workarounds have no counterpart: nothing is
compiled here.

Under data parallelism every rank must demote together, or their
collectives stop matching.  Each try then runs
:meth:`TrainStep.path_length_sums` (no collective), all ranks exchange a
failure flag (a MAX all-reduce), and only when no rank failed do they reduce
the sums (:meth:`TrainStep.path_length_from_sums`); a failure on any rank
demotes every rank.  The tiers come from the global path-length batch, so
every rank walks the same ladder whatever its share of the rows.  Under
tensor parallelism the sums stage itself gathers channels over the model
group (parallel/tensor.py), so an out-of-memory error that strikes one
model rank alone inside it leaves the others waiting at a gather until the
process group's timeout; the ranks of a model group run the same shapes, so
their memory use is the same.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Tuple

import torch

from multi_stylegan_torch.parallel import mesh
from multi_stylegan_torch.train.state import TrainState
from multi_stylegan_torch.utils.profiling import span


def pl_chunk_tiers(pl_batch: int) -> Tuple[int, ...]:
    """Chunk counts of the ladder below the unchunked form: 2 and 4, half
    the batch and the whole batch (sub-batch 1), those that divide it
    (JAX robust.py:37-48)."""
    cand = {2, 4, pl_batch // 2, pl_batch}
    return tuple(sorted(n for n in cand if 2 <= n <= pl_batch and pl_batch % n == 0))


class RobustPathLength:
    """``(state, draws) -> (penalty, path length, metrics)`` through the
    ladder of chunkings of ``step`` (a :class:`TrainStep`)."""

    def __init__(self, step, report: Callable[[str], None] = print) -> None:
        self.step = step
        self.report = report
        # JAX robust.py:37-48; a rank's rows split into each tier's chunks
        # (train/steps.py::path_length_sums), some empty where it holds few
        self.tiers = (1,) + pl_chunk_tiers(step.path_length_batch(step.cfg.batch_size))
        self.index = 0  # into tiers; len(tiers) once every tier has failed

    @property
    def chunks(self) -> int:
        """The active tier's chunk count, 0 when the update is skipped."""
        return self.tiers[self.index] if self.index < len(self.tiers) else 0

    def _demote(self, message: str) -> None:
        failed = self.chunks
        self.index += 1
        if self.chunks:
            self.report(f"path length: out of memory in {failed} chunk(s); "
                        f"retrying in {self.chunks} chunks")
        else:
            warnings.warn(
                f"path-length regularization DISABLED: out of memory at every chunking "
                f"{self.tiers} ({message.splitlines()[0][:200]}). Training continues "
                "without it.", RuntimeWarning)

    def grads(self, state: TrainState, pld):
        """:meth:`TrainStep.path_length_grads` of the draws ``pld`` at the
        active tier, demoted on out-of-memory until a tier runs; None once
        every tier has failed."""
        while self.chunks:
            with span("train.path_length.tier", chunks=self.chunks) as tier:
                out, message = self._try(state, pld)
                tier.set(ok=out is not None)
            if out is not None:
                return out
            # the failed pass's tensors went with the exception's frames
            if pld.probe.device.type == "cuda":
                torch.cuda.empty_cache()
            self._demote(message)
        return None

    def _try(self, state: TrainState, pld):
        """(the grads stage's output, "") at the active tier, or (None, the
        out-of-memory message) when it, or under data parallelism any
        rank's, ran out of memory."""
        step = self.step
        if mesh.process_count() == 1:
            try:
                return step.path_length_grads(state, pld, self.chunks), ""
            except torch.cuda.OutOfMemoryError as exc:
                return None, str(exc)
        sums, message = None, "out of memory on another rank"
        try:
            sums = step.path_length_sums(state, pld, self.chunks)
        except torch.cuda.OutOfMemoryError as exc:
            message = str(exc)
        if mesh.any_rank(sums is None, pld.probe.device):
            return None, message
        return step.path_length_from_sums(state, *sums), ""

    def __call__(self, state: TrainState, draws) -> Tuple[torch.Tensor, torch.Tensor,
                                                          Dict[str, torch.Tensor]]:
        """One path-length update (draws, grads through the ladder, G step,
        EMA); once every tier has failed it is skipped: penalty and length
        0, and the G parameters, the running mean and the EMA as they were."""
        step = self.step
        with span("train.path_length"):
            out = self.grads(state, step.draw_path_length(state.generator, step.cfg.batch_size,
                                                          draws))
            dev = state.mean_path_length.device
            if out is not None:
                grads, pen, pl, new_mean = out
                step.path_length_apply(state, grads, new_mean)
                return pen, pl, {
                    "path_length_chunks": torch.tensor(float(self.chunks), device=dev),
                    "path_length_skipped": torch.zeros((), device=dev)}
        zero = torch.zeros((), device=dev)
        return zero, zero, {"path_length_chunks": zero,
                            "path_length_skipped": torch.ones((), device=dev)}
