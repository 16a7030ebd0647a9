"""How sharp ``chip_smoke.py``'s ring gates (phase 11 (b)) are, on the card.

    python3 scripts/ring_gate_controls.py [--faults none,ring_gather_one_block,...]

Phase 11's weights (full-width mixtral-8x7b cut to 8 of 32 layers, seed
0) serve (b)'s paged ring (2 prompts of 4,600 past the 4,096 window)
once with each planted fault of the engine's ring path, first in bf16
and then on the same weights cast to f32; each run is held to
``launch.steps``' windowed oracle as phase 11 holds it, and the line
gives its readings and the ``chip_smoke.RING_GATES`` it misses.  A fault
that misses no gate is flagged, and the script exits 1.  The faults
touch only the engine's side (the oracle runs the whole prompt and the
slab ring):

- ``ring_gather_one_block``: the ring decode gathers the chain's first
  block for every slot (16 keys instead of the window);
- ``pad_writes_kept``: a chunk's pad positions past the prompt are
  written onto the ring, over in-window positions (what ``valid_to``
  prevents);
- ``chunk_window_dropped``: the windowed prefill chunks attend to every
  earlier position, not the last 4,096.

Needs one card and the CUDA toolkit (it builds the kernels as
``chip_smoke.py`` does); ~5 min.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

import chip_smoke  # noqa: E402

FAULTS = ("none", "ring_gather_one_block", "pad_writes_kept",
          "chunk_window_dropped")


@contextlib.contextmanager
def planted(name):
    """The engine's ring path with fault ``name`` (module attributes
    swapped for the duration; the engine is built and captured inside)."""
    from repro_torch.models import attention as A
    from repro_torch.serve import kvstore
    saved = []

    def swap(mod, attr, fn):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)
    if name == "ring_gather_one_block":
        orig = A.paged_ring_decode_attention

        def one_block(q, k, v, block_table, cache_len, **kw):
            first = block_table[:, :1].expand_as(block_table).contiguous()
            return orig(q, k, v, first, cache_len, **kw)
        swap(A, "paged_ring_decode_attention", one_block)
    elif name == "pad_writes_kept":
        orig = kvstore.write_chunk_blocks

        def kept(*args, valid_to=None, **kw):
            return orig(*args, **kw)
        swap(kvstore, "write_chunk_blocks", kept)
    elif name == "chunk_window_dropped":
        orig = A.chunked_attention

        def unwindowed(q, k, v, **kw):
            if "q_offset" in kw:            # the engine's chunks only
                kw["window"] = 0
            return orig(q, k, v, **kw)
        swap(A, "chunked_attention", unwindowed)
    elif name != "none":
        raise ValueError(f"unknown fault {name!r}; choose from {FAULTS}")
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args()
    faults = args.faults.split(",")
    import torch
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    if not torch.cuda.is_available():
        print("ring_gate_controls: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    mix = chip_smoke.mixtral_config()
    params = build_model(mix, batch=2, seq_len=4600 + 32).init(0)
    missed = []
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            gc.collect()
            torch.cuda.empty_cache()
            chip_smoke._cast_(params, torch.float32)
        cfg = mix.replace(dtype=dtype)
        for name in faults:
            with planted(name):
                line = chip_smoke.ring_serve(cfg, params,
                                             f"control-{name}", paged=True)
            rec = {"fault": name, "dtype": dtype,
                   "gate_failures": line["gate_failures"],
                   **{f"r{rid}_{k}": ag[k] for rid, ag in line["oracle"].items()
                      for k in ("agree", "steps", "logits_err_max",
                                "logits_err_median_after_wrap")}}
            print(f"[control] {json.dumps(rec)}", flush=True)
            if (name == "none") != (not line["gate_failures"]):
                missed.append(f"{dtype} {name}")
            gc.collect()
            torch.cuda.empty_cache()
    print(f"[control] {'flagged: ' + ', '.join(missed) if missed else 'every fault fails a gate, the clean runs pass'}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
