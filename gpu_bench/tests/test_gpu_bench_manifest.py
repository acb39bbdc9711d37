"""BENCHMARK.json resolves: every cell, configuration, traffic mix, driver,
per-layer reader and limit file is found by name, and every cell reports
what its metrics move."""

import re

import pytest

from gpu_bench import bench, check

MANIFEST = bench.load_json(bench.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in MANIFEST[k]}) == len(MANIFEST[k])
    metrics = [x["name"] for x in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in metrics and 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves(cell):
    c = bench.find_cell(cell)
    assert hasattr(c.driver, "run")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert hasattr(bench.metric_reader(m["name"]), "read")
    assert set(check.limits(cell)) and all(v > 0 for v in check.limits(cell).values())


def test_configs_and_layers():
    for c in MANIFEST["configs"]:
        assert (bench.ROOT / c["file"]).is_file() and c["file"].startswith("gpu_bench/")
        assert bench.load_json(bench.ROOT / c["file"])["reduced"] == c["reduced"]
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers == {"train loop", "regularizers", "models", "kernels", "device"}
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"] or "idle" in m["name"]:
            assert m["unit"] == "%"
