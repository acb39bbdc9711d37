"""Nothing of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the port: by a scan of the sources and by the modules a CPU
rehearsal of a run leaves loaded (top-level names compared whole)."""

import ast
import json
import subprocess
import sys
import textwrap

from gpu_bench import bench


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources():
    for path in bench.BENCH.rglob("*.py"):
        assert not top_level_imports(path) & set(bench.FORBIDDEN), path
        if "reference" in path.parts:
            assert "multi_stylegan_torch" not in top_level_imports(path), path


def test_rehearsal_loads_no_jax():
    script = textwrap.dedent("""
        import json, sys, torch
        torch.set_num_threads(2)
        from gpu_bench import run
        from gpu_bench.tests.tiny import overrides
        for cell, trace in (("sample-msg256-f32-b16", 1), ("train-msg256-bf16-b24", 0)):
            args = run.parse(["--workload", cell, "--seed", "2500000000", "--seconds", "0.5",
                              "--trace", str(trace)])
            run.execute(args, device="cpu", overrides=overrides(cell))
        print(json.dumps([m for m in sys.modules if m.split(".")[0] in
                          ("jax", "jaxlib", "flax", "multi_stylegan_tpu")]))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=bench.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
