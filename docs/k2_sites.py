#!/usr/bin/env python3
"""K2's per-site rows from ``chip_smoke.py --out`` files, as Markdown.

    python3 docs/k2_sites.py RUN.json [RUN.json ...]

For each file: one row per K2 site and form (``site`` rows of phase 5), the
time per launch and the bound in f32 and in bf16, the launches per f32 and
per bf16 regularised iteration; then each iteration's K2 time, bound and
gap (time - bound) summed over the sites from 64x64 up, at 32x32, and below
(the 4x4-16x16 maps and the [B, C] mapping and head sites).  It reads only
what chip_smoke.py measured; docs/PORT_FLR_SITES.md holds its output.
"""

from __future__ import annotations

import json
import sys


def group(shape) -> str:
    if len(shape) == 2:
        return "below 32x32"
    return "64x64 and up" if shape[1] >= 64 else ("32x32" if shape[1] == 32 else "below 32x32")


def report(path: str) -> None:
    run = json.load(open(path))
    rows = run["train_sites"]["K2"]
    print(f"### {path} ({run['card']})\n")
    print("| shape | form | launches f32 iter | launches bf16 iter (bf16 + f32) | ms | bound ms "
          "| bound/ms | ms bf16 | bound ms bf16 | bound/ms bf16 | max err f32 / bf16 |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (-r["bound_ms"], r.get("part", ""))):
        print(f"| {'×'.join(map(str, r['shape']))} | {r.get('part', 'dx and db')} "
              f"| {r['launches_per_iteration']} "
              f"| {r['launches_bf16_iteration_bf16']} + {r['launches_bf16_iteration_f32']} "
              f"| {r['ms']:.4f} | {r['bound_ms']:.4f} | {r['bound_ms'] / r['ms']:.3f} "
              f"| {r['ms_bf16']:.4f} | {r['bound_ms_bf16']:.4f} "
              f"| {r['bound_ms_bf16'] / r['ms_bf16']:.3f} "
              f"| {r['max_abs_err_float32']:.2g} / {r['max_abs_err_bfloat16']:.2g} |")
    print("\n| iteration | sites | launches | ms | bound ms | gap ms | bound/ms |")
    print("|---|---|---|---|---|---|---|")
    for label in ("f32", "bf16"):
        totals = {}
        for r in rows:
            if label == "f32":
                parts = [(r["launches_per_iteration"], r["ms"], r["bound_ms"])]
            else:
                parts = [(r["launches_bf16_iteration_bf16"], r["ms_bf16"], r["bound_ms_bf16"]),
                         (r["launches_bf16_iteration_f32"], r["ms"], r["bound_ms"])]
            for n, ms, bound in parts:
                t = totals.setdefault(group(r["shape"]), [0, 0.0, 0.0])
                t[0] += n
                t[1] += n * ms
                t[2] += n * bound
        totals["all"] = [sum(t[i] for t in list(totals.values())) for i in range(3)]
        for name in ("64x64 and up", "32x32", "below 32x32", "all"):
            n, ms, bound = totals.get(name, (0, 0.0, 0.0))
            share = f"{bound / ms:.3f}" if ms else "—"
            print(f"| {label} | {name} | {n} | {ms:.2f} | {bound:.2f} | {ms - bound:.2f} | {share} |")
    print()


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        report(arg)
