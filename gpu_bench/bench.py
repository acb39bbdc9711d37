"""What every part of the harness shares: where things are, finding a cell's
configuration, traffic and metrics by name, and building the port's and the
reference's configurations from a configuration file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Build outputs and traces of a run, inside the checkout (gitignored):
# fixed paths, so that a second run of a cell finds every kernel built.
OUT = ROOT / "build" / "gpu_bench"
MANIFEST = ROOT / "BENCHMARK.json"

# What no process of a run may load (compared by whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_stylegan_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path) -> ModuleType:
    """A module of the harness found by file name (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"gpu_bench_{path.stem.replace('.', '_')}",
                                                  path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self) -> ModuleType:
        return load_file(BENCH / "drivers" / f"{self.traffic['driver']}.py")


def _reports(metric: dict, cell: str, end_to_end: Optional[List[str]] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end is None or metric["moves"] in end_to_end


def find_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    m = load_json(MANIFEST) if manifest is None else manifest
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    w = by_name[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    names = [x["name"] for x in e2e]
    per_layer = [x for x in m["per_layer"] if _reports(x, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def metric_reader(name: str) -> ModuleType:
    return load_file(BENCH / "metrics" / f"{name}.py")


def _build(classes, config: dict, overrides: Dict[str, dict]):
    out = []
    for cls, key in zip(classes, ("generator", "discriminator", "training")):
        kw = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
              if isinstance(v, list) else v for k, v in config.get(key, {}).items()}
        kw.update(overrides.get(key, {}))
        out.append(cls(**kw))
    return tuple(out)


def port_configs(config: dict, **overrides):
    """(GeneratorConfig, DiscriminatorConfig, TrainingConfig) of the port."""
    from multi_stylegan_torch.models.config import (
        DiscriminatorConfig,
        GeneratorConfig,
        TrainingConfig,
    )

    return _build((GeneratorConfig, DiscriminatorConfig, TrainingConfig), config, overrides)


def reference_configs(config: dict, **overrides):
    """The same configurations as the reference's classes."""
    from gpu_bench.reference.config import (
        DiscriminatorConfig,
        GeneratorConfig,
        TrainingConfig,
    )

    return _build((GeneratorConfig, DiscriminatorConfig, TrainingConfig), config, overrides)
