"""Checkpoint exporter: a checkpoint of the port's trainer -> the reference's
6-key ``.pt`` (the JAX package's cli/export.py, which reads orbax).

    python -m multi_stylegan_torch.cli.export exp/models checkpoint_100.pt

``source`` is a ``checkpoint_<step>.pt`` or a models directory (its newest
step).  G, G-EMA, D, the noise buffers and both Adam states move exactly
(io/reference.py), in the layout and parameter order the reference's own
resume path (train_multi_stylegan.py:73-86) reads.  The reference format
cannot carry the path-length mean, the ADA state or the step.  Runs on the
CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from multi_stylegan_torch.cli.train import model_configs
from multi_stylegan_torch.io.checkpoint import load_train_state, read_checkpoint
from multi_stylegan_torch.io.reference import export_reference_checkpoint
from multi_stylegan_torch.models.config import TrainingConfig
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.train.state import create_train_state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source", type=str,
                        help="The port's checkpoint_<step>.pt, or a directory of them.")
    parser.add_argument("dest", type=str, help="Output .pt path.")
    parser.add_argument("--compat_tower2_bug", default=False, action="store_true",
                        help="Source config used the reference's tower-2 output wiring.")
    parser.add_argument("--tiny", default=False, action="store_true",
                        help="Use the 32px debug config.")
    return parser


def main(argv: Optional[List[str]] = None) -> str:
    """Run the exporter; returns the path written."""
    args = build_parser().parse_args(argv)
    source = os.path.abspath(args.source)
    saved = read_checkpoint(source)
    gcfg, dcfg = model_configs(args.tiny, args.compat_tower2_bug)
    cfg = TrainingConfig()
    state = create_train_state(Generator(gcfg), Discriminator(dcfg), cfg)
    load_train_state(state, saved["train_state"])
    dest = os.path.abspath(args.dest)
    torch.save(export_reference_checkpoint(state, cfg), dest)
    print(f"Exported {source} (step {state.step}) -> {dest} (reference 6-key format, "
          f"Adam count {int(state.g_opt.count)})")
    return dest


if __name__ == "__main__":
    main()
