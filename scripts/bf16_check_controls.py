"""How sharp ``chip_smoke.py``'s bf16 logits check is, on the CPU.

    PYTHONPATH=src python scripts/bf16_check_controls.py [--seeds 8]

For each seed, reduced moonshot-v1-16b-a3b in bf16 through the plain
versions against the f32 logits of the same weights: once with every run
routing on its own (bf16 roundings flip some tokens' experts), once with
the bf16 runs replaying the f32 run's experts (what the check does), and
with each planted fault of the check on the replayed experts.  Each gap is
a share of the largest f32 logit.  A seed's check limit is
``BF16_NOISE_FACTOR`` x its replayed bf16 gap; a fault that stays within
it is flagged.  Needs no GPU; the card's own numbers come from
``chip_smoke.py``'s ``[reference]`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    flagged = 0
    for seed in range(args.seeds):
        free = chip_smoke.bf16_logit_gaps(seed, "cpu", replay=False)
        rep = chip_smoke.bf16_logit_gaps(seed, "cpu")
        limit = chip_smoke.BF16_NOISE_FACTOR * rep["cpu_vs_f32"]
        faults = {n: rep[f"fault_{n}_vs_f32"] for n in chip_smoke.BF16_FAULTS}
        missed = [n for n, g in faults.items() if g <= limit]
        flagged += len(missed)
        print(json.dumps({"seed": seed, "free_routing_vs_f32":
                          free["cpu_vs_f32"], "replayed_vs_f32":
                          rep["cpu_vs_f32"], "limit": limit,
                          "faults_vs_f32": faults, "faults_within_limit":
                          missed}), flush=True)
    return 1 if flagged else 0


if __name__ == "__main__":
    sys.exit(main())
