"""Checkpoint converter: a reference-format ``.pt`` -> a checkpoint of the
port's trainer (the JAX package's cli/convert.py, which writes orbax).

    python -m multi_stylegan_torch.cli.convert checkpoint_100.pt out/models
    python -m multi_stylegan_torch.cli.train --load_checkpoint out/models ...
    python -m multi_stylegan_torch.cli.sample --checkpoint out/models ...

Writes ``<dest>/checkpoint_<step>.pt`` holding G, G-EMA (with the noise
buffers), D and, when the ``.pt`` carries the optimizer state dicts (the
reference's own checkpoints do), both Adam states, moved exactly
(io/reference.py).  The step is ``--step``; the ADA state starts at
``ada_p_init`` and the path-length mean at 0 unless the file holds one: the
reference format carries neither.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from multi_stylegan_torch.cli.train import model_configs
from multi_stylegan_torch.io.checkpoint import CheckpointManager, read_checkpoint, train_state_dict
from multi_stylegan_torch.io.reference import import_reference_checkpoint
from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train.state import create_train_state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source", type=str, help="Reference-format .pt checkpoint.")
    parser.add_argument("dest", type=str, help="Directory for checkpoint_<step>.pt.")
    parser.add_argument("--step", default=0, type=int,
                        help="Step counter of the written state (the reference does not "
                             "checkpoint it).")
    parser.add_argument("--compat_tower2_bug", default=False, action="store_true",
                        help="Target config reproduces the reference's tower-2 output wiring "
                             "(published checkpoints were trained with it).")
    parser.add_argument("--tiny", default=False, action="store_true",
                        help="Use the 32px debug config.")
    return parser


def main(argv: Optional[List[str]] = None) -> str:
    """Run the converter; returns the path written."""
    args = build_parser().parse_args(argv)
    gcfg, dcfg = model_configs(args.tiny, args.compat_tower2_bug)
    state = create_train_state(Generator(gcfg), Discriminator(dcfg), TrainingConfig())
    found = import_reference_checkpoint(state, read_checkpoint(args.source))
    state.step = args.step
    path = CheckpointManager(os.path.abspath(args.dest)).save(
        args.step, {"train_state": train_state_dict(state)})
    print(f"Converted {args.source} -> {path} (G, G-EMA, D"
          + "".join(f", {what}" for what in found) + f"; step {args.step})")
    return path


if __name__ == "__main__":
    main()
