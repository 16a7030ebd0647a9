#!/usr/bin/env python3
"""Time the ways to build the ``VirtualGroup`` fetch's rows on the card:
the gather of the G x K rows from the rank-major weight, and the forms
that also zero the rows of the -1 ids (a broadcast multiply, the one
``core/dispatch.py`` uses; ``index_fill_`` into a dump row; ``torch.where``;
a diagonal product; ``embedding_bag`` with per-row weights).  One bf16
matrix at qwen15-moe-a27b's width (15 experts a rank, G = 4, K = 4,
2048 x 1408), the skew's FIDS (every rank fetches expert 0, a few more).
Each form is checked equal to the multiply, then timed with CUDA events
over 50 back-to-back calls.

    python3 scripts/fetch_mask_forms.py
"""
import json
import subprocess

import torch
import torch.nn.functional as F


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fetch_mask_forms: needs a CUDA device")
    dev = "cuda"
    G, K, epr, d, f = 4, 4, 15, 2048, 1408
    w = torch.randn(G * epr, d, f, device=dev).to(torch.bfloat16)
    fids = torch.tensor([[0, 7, -1, -1], [0, -1, -1, -1], [0, 3, 22, -1],
                         [0, -1, -1, -1]], device=dev)
    ids = fids.reshape(-1)
    rows = torch.clamp(ids, min=0)
    keep = (ids >= 0).to(w.dtype)

    def multiply():
        return w[rows] * keep.view(-1, 1, 1)

    def index_fill():
        out = w[torch.cat([rows, rows[:1]])]
        at = torch.arange(G * K, device=dev)
        out.index_fill_(0, torch.where(ids >= 0, G * K, at), 0)
        return out[:G * K]

    def where():
        return torch.where((ids >= 0).view(-1, 1, 1), w[rows], 0)

    def diagonal():
        return (torch.diag(keep) @ w[rows].view(G * K, -1)).view(G * K, d, f)

    def embedding_bag():
        return F.embedding_bag(rows.view(-1, 1), w.view(G * epr, -1),
                               mode="sum", per_sample_weights=keep.view(-1, 1)
                               ).view(G * K, d, f)

    def gather_only():
        return w[rows]

    want = multiply()
    out = {}
    for name, fn in (("multiply", multiply), ("index_fill", index_fill),
                     ("where", where), ("diagonal", diagonal),
                     ("embedding_bag", embedding_bag),
                     ("gather_only", gather_only)):
        got = fn()
        equal = None if name == "gather_only" else bool(torch.equal(got, want))
        for _ in range(3):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(50):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / 50, "equal": equal}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
