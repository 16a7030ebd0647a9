#!/usr/bin/env python3
"""Print the dry-run matrix as a markdown table, one row a cell, the
single-pod (16 x 16) and multi-pod (2 x 16 x 16) meshes side by side,
from the JSON files ``python -m repro_torch.launch.dryrun --all
--both-meshes`` writes under ``results/dryrun_torch/``.

    PYTHONPATH=src python scripts/dryrun_table.py
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.configs import iter_cells  # noqa: E402
from repro_torch.launch.dryrun import RESULTS_DIR  # noqa: E402


def _load(arch, shape, tag):
    path = os.path.join(RESULTS_DIR, f"{arch}__{shape}__{tag}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main() -> int:
    print("| arch | shape | parameters | model FLOPs (step) | counted FLOPs "
          "a device, single / multi | argument GB a device, single / multi "
          "| fits 80 GB | seconds, single / multi |")
    print("|---|---|---|---|---|---|---|---|")
    missing, total_s = [], 0.0
    for arch, shape, runnable, _ in iter_cells(include_skipped=True):
        if not runnable:
            continue
        runs = [_load(arch, shape.name, t) for t in ("single", "multi")]
        if any(r is None for r in runs):
            missing.append((arch, shape.name))
            continue
        s, m = runs
        total_s += s["wall_s"] + m["wall_s"]
        fits = "yes" if s["fits"] and m["fits"] else (
            "single only" if s["fits"] else "no")
        print(f"| {arch} | {shape.name} | {s['param_count']:,} | "
              f"{s['model_flops']:.3e} | {s['flops']:.3e} / "
              f"{m['flops']:.3e} | "
              f"{s['memory']['argument_bytes'] / 1e9:.3f} / "
              f"{m['memory']['argument_bytes'] / 1e9:.3f} | {fits} | "
              f"{s['wall_s']:.1f} / {m['wall_s']:.1f} |")
    print(f"\ncells' seconds summed: {total_s:.1f}")
    if missing:
        print(f"missing: {missing}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
