"""Checkpoints of the whole training state (the JAX package's
io/checkpoint.py, on ``torch.save`` instead of orbax).

A checkpoint is one ``models/checkpoint_<step>.pt`` holding what the JAX
``TrainState`` holds (train/state.py): the step, the generator's, EMA
generator's and discriminator's state dicts (the generator's noise buffers
included), both :class:`~multi_stylegan_torch.train.state.ClippedAdam`
states, the ADA controller and the path-length running mean.  The trainer
adds the two things the JAX state keeps as PRNG keys and the port keeps
elsewhere: its draws' ``torch.Generator`` state and the loader's numpy
rng states (train/loop.py), so that a resumed run replays the
uninterrupted run's draws and batch order.

:class:`CheckpointManager` keeps the last ``max_to_keep`` files and writes
each to a temporary name first, then ``os.replace``-s it, so a crash never
leaves a torn latest checkpoint.  Restoring reads the file memory-mapped on
the host and copies every tensor into the live modules and tensors in place
(``load_state_dict`` / ``copy_``): no second training state is built on the
device, whose memory the iteration needs (the JAX ``restore_latest`` drops
its live state for the same reason, loop.py:484-497).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

from multi_stylegan_torch.parallel import tensor as tp
from multi_stylegan_torch.train.state import TrainState

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def train_state_dict(state: TrainState, full: bool = False) -> Dict[str, Any]:
    """The tensors and counters of ``state`` (references, not copies); with
    ``full`` the one-process layout: its tensor-parallel blocks gathered
    whole (every rank of the model group takes part)."""
    module_sd = tp.full_module_state if full else (lambda m: m.state_dict())
    opt_sd = (lambda o: o.full_state_dict()) if full else (lambda o: o.state_dict())
    ada = state.ada
    return {
        "step": state.step,
        "generator": module_sd(state.generator),
        "g_ema": module_sd(state.g_ema),
        "discriminator": module_sd(state.discriminator),
        "g_opt": opt_sd(state.g_opt),
        "d_opt": opt_sd(state.d_opt),
        "ada": {"p": ada.p, "r_sum": ada.r_sum, "r_count": ada.r_count, "last_r": ada.last_r},
        "mean_path_length": state.mean_path_length,
    }


@torch.no_grad()
def load_train_state(state: TrainState, saved: Dict[str, Any]) -> None:
    """Copy a :func:`train_state_dict` (of any layout) into ``state``'s live
    tensors; under tensor parallelism each rank keeps its blocks."""
    state.step = int(saved["step"])
    state.generator.load_state_dict(saved["generator"])
    state.g_ema.load_state_dict(saved["g_ema"])
    state.discriminator.load_state_dict(saved["discriminator"])
    state.g_opt.load_state_dict(saved["g_opt"])
    state.d_opt.load_state_dict(saved["d_opt"])
    for name, value in saved["ada"].items():
        getattr(state.ada, name).copy_(value)
    state.mean_path_length.copy_(saved["mean_path_length"])


def read_checkpoint(path: str) -> Dict[str, Any]:
    """What a checkpoint file holds (the trainer's, or a reference-format
    .pt), or a directory's newest ``checkpoint_<step>.pt``, memory-mapped on
    the host (tensors and plain containers only)."""
    if os.path.isdir(path):
        manager = CheckpointManager(path)
        if manager.latest_step() is None:
            raise FileNotFoundError(f"{path}: no checkpoint_<step>.pt there")
        return manager.load()
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)


class CheckpointManager:
    """Rolling ``checkpoint_<step>.pt`` files under ``root``."""

    def __init__(self, root: str, max_to_keep: int = 5) -> None:
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_to_keep = max_to_keep
        os.makedirs(self.root, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"checkpoint_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m[1]) for m in map(_NAME.match, os.listdir(self.root)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        """Write ``payload`` as step ``step``'s checkpoint, then drop all but
        the newest ``max_to_keep``; returns the path."""
        path = self.path(step)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def load(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Step ``step``'s checkpoint (default the latest), memory-mapped on
        the host."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint_<step>.pt in {self.root}")
        return torch.load(self.path(step), map_location="cpu", mmap=True, weights_only=True)
