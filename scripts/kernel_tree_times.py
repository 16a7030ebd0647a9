#!/usr/bin/env python3
"""Device time of the attention kernels at fixed cases, for the checkout
at ``--tree`` (default: this one), so that two commits can be timed in
one call on one card.

    python3 scripts/kernel_tree_times.py [--tree DIR] [--tag NAME]

Imports ``chip_smoke`` and ``repro_torch`` from ``DIR`` (an unpacked
``git archive`` of another commit, say), builds that tree's kernels into
its own ``build/kernels/``, and runs its ``paged_attention_case`` and
``flash_attention_case`` (parity against the plain version, then device
ms, event ms, the plain version's and SDPA's ms, the bound) at widths
both commits' kernels take: the serve decode and long chains at 16 x 128
heads, stablelm's 32 x 64 decode, gemma2-2b's 8 q / 4 kv heads of 256
with its softcap (decode and a 32-query chunk, f32), the whole-prompt
prefill at 16 x 128 and the f32 GQA ragged case.  One JSON line per
case, tagged with ``--tag`` and the card's name and power limit.  Run
the two trees in turns (parent, change, change, parent).  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    secs = build.build_all()
    card = cs.smi_line()
    bf, f32 = torch.bfloat16, torch.float32
    qwen = dict(H=16, Hkv=16, hd=128, softcap=0.0)
    gemma = dict(H=8, Hkv=4, hd=256, softcap=50.0)
    paged = [
        ("decode", bf, qwen, dict(B=4, S=1, bs=16,
                                  lengths=[1, 77, 200, 288], n_blocks=18)),
        ("long_decode", bf, qwen, dict(B=4, S=1, bs=16,
                                       lengths=[1024, 2048, 3072, 4096],
                                       n_blocks=256)),
        ("stablelm_decode", bf, dict(H=32, Hkv=32, hd=64, softcap=0.0),
         dict(B=4, S=1, bs=16, lengths=[1, 129, 336, 544], n_blocks=34)),
        ("gemma2_decode", f32, gemma, dict(B=4, S=1, bs=16,
                                           lengths=[1, 129, 336, 544],
                                           n_blocks=34)),
        ("gemma2_prefill_chunk", f32, gemma, dict(
            B=1, S=32, bs=68, lengths=[448], n_blocks=8, slab=True)),
    ]
    for seed, (label, dtype, heads, shape) in enumerate(paged):
        rec = cs.paged_attention_case(label, dtype=dtype, seed=seed,
                                      time_it=True, **heads, **shape)
        print(json.dumps({"tag": args.tag, "kernel": "paged_attention",
                          "card": card, "build_s": secs, **rec}),
              flush=True)
    flash = [("prefill", bf, dict(B=4, H=16, Hkv=16, Sq=1024, Sk=1024,
                                  hd=128)),
             ("f32_gqa_ragged_causal", f32, dict(B=2, H=8, Hkv=2, Sq=201,
                                                 Sk=201, hd=128))]
    for seed, (label, dtype, shape) in enumerate(flash, start=10):
        rec = cs.flash_attention_case(label, causal=True, dtype=dtype,
                                      seed=seed, **shape)
        print(json.dumps({"tag": args.tag, "kernel": "flash_attention",
                          "card": card, "build_s": secs, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
