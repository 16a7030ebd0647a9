#!/usr/bin/env python3
"""Device time of the paged_attention kernel against its split count.

    python3 scripts/paged_attention_splits.py

Runs ``chip_smoke.paged_attention_case`` (parity against the plain version,
then device ms, event ms, the plain version's and SDPA's ms, and the bound)
at the serve decode, serve prefill chunk and long-chain decode shapes of
qwen15-moe-a27b, once with the launch plan the wrapper picks and once for
each SM count in ``--sms``: the planner sizes the split for four waves of
that many SMs, so a larger count gives more, shorter spans.  ``pair_ms``
is the device time of two calls queued back to back, so ``pair_ms - ms``
is a call's cost behind another kernel, without the first launch's
latency.  One JSON line per case and count.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pair_ms(chip_smoke, ops, kw) -> float:
    """Device ms of two back-to-back calls on the case's inputs."""
    import torch
    kw = dict(kw)
    bs = kw["bs"]
    q, k, v, table, cl = chip_smoke.paged_attention_inputs(
        H=16, Hkv=16, hd=128, dtype=torch.bfloat16, **kw)

    def call():
        return ops.paged_attention(q, k, v, table, cl, block_size=bs)
    return chip_smoke.device_ms(lambda: (call(), call()), 20)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sms", type=int, nargs="*", default=[1, 66, 198])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_attention_splits: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels.paged_attention import ops
    print(chip_smoke.smi_line(), flush=True)
    bf = torch.bfloat16
    cases = {
        "decode": dict(B=4, S=1, bs=16, lengths=[1, 77, 200, 288],
                       n_blocks=18, seed=3),
        "prefill_chunk": dict(B=1, S=32, bs=96, lengths=[192], n_blocks=3,
                              seed=4, slab=True),
        "long_decode": dict(B=4, S=1, bs=16,
                            lengths=[1024, 2048, 3072, 4096], n_blocks=256,
                            seed=9),
    }
    default = ops._sm_count
    for sms in [None, *args.sms]:
        ops._sm_count = default if sms is None else (lambda device, n=sms: n)
        for label, kw in cases.items():
            rec = chip_smoke.paged_attention_case(
                label, H=16, Hkv=16, hd=128, softcap=0.0, dtype=bf,
                time_it=True, **kw)
            rec["sms_for_plan"] = sms or default(torch.device("cuda"))
            rec["pair_ms"] = pair_ms(chip_smoke, ops, kw)
            print(json.dumps(rec), flush=True)
    ops._sm_count = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
