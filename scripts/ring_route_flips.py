"""Where phase 11's f32 ring leaves the windowed oracle, on the card.

    python3 scripts/ring_route_flips.py

Phase 11's weights (full-width mixtral-8x7b cut to 8 of 32 layers, seed
0) cast to f32 serve (b)'s paged ring (2 prompts of 4,600, chunks of
512) twice: captured, then eager with every MoE layer's top-2 experts
recorded.  For each request it prints whether the two runs' logits rows
are bit-equal, each step's logits error against ``launch.steps``'
windowed oracle fed the engine's tokens (relative to the oracle's
largest logit), and, layer by layer, the prompt tokens whose experts
differ between the engine's chunks and the oracle's whole prompt, with
the oracle's gap between its 2nd and 3rd router logits there (relative
to its largest), and the smallest such gap of each decode step.  Needs
one card and the CUDA toolkit; ~2 min.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.core import moe_layer, router
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, engine_config_for, stepcore
    if not torch.cuda.is_available():
        print("ring_route_flips: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    mix = chip_smoke.mixtral_config()
    shape = chip_smoke.MIX_RING
    n, L, new, C = (shape["slots"], shape["prompt_len"], shape["new_tokens"],
                    shape["prefill_chunk"])
    params = build_model(mix, batch=n, seq_len=L + new).init(0)
    chip_smoke._cast_(params, torch.float32)
    cfg = mix.replace(dtype="float32")
    NL = cfg.num_layers
    ecfg = engine_config_for(cfg, max_slots=n, prompt_len=L,
                             max_new_tokens=new, prefill_chunk=C, paged=True,
                             kv_block_size=shape["block_size"])
    rng = np.random.default_rng(32)          # ring_serve's paged prompts
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (L,)),
                    max_new_tokens=new) for i in range(n)]
    model = build_model(cfg, batch=n, seq_len=ecfg.max_seq_len)
    rec = []

    def route(x, w, *, top_k, num_real_experts):
        out = router.route_topk(x, w, top_k=top_k,
                                num_real_experts=num_real_experts)
        v = torch.sort(x.float() @ w.float(), dim=-1, descending=True).values
        rec.append((torch.sort(out.assign.long(), dim=-1).values.cpu(),
                    ((v[:, 1] - v[:, 2]) / v[:, 0].abs()).cpu()))
        return out
    outs, _, _, _, _, _, rows = chip_smoke._serve_streams(
        model, params, ecfg, reqs)
    moe_layer.route_topk = route
    try:
        with stepcore.eager():
            e_outs, _, _, _, _, _, e_rows = chip_smoke._serve_streams(
                build_model(cfg, batch=n, seq_len=ecfg.max_seq_len), params,
                ecfg, reqs)
        # the engine's chunk calls, after warmup's one chunk: each
        # request's chunks in turn, NL layers each
        chunks = [r for r in rec if r[0].shape[0] == C][NL:]
        for r in reqs:
            same = outs[r.rid] == e_outs[r.rid] and all(
                torch.equal(a, b) for a, b in zip(rows[r.rid],
                                                  e_rows[r.rid]))
            rec.clear()
            orc = chip_smoke.windowed_oracle(cfg, params, r.tokens,
                                             outs[r.rid])
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(rows[r.rid], orc)]
            print(f"[flips] request {r.rid}: captured = eager bit for bit: "
                  f"{same}; logits error a step: "
                  + " ".join(f"{e:.1e}" for e in errs), flush=True)
            n_chunks = -(-L // C)
            mine = chunks[r.rid * n_chunks * NL:(r.rid + 1) * n_chunks * NL]
            for layer in range(NL):
                e = torch.cat([mine[c * NL + layer][0]
                               for c in range(n_chunks)])[:L]
                o, gap = rec[layer]
                bad = (e != o).any(-1).nonzero().flatten().tolist()
                print(f"[flips] request {r.rid} layer {layer}: {len(bad)} of "
                      f"{L} prompt tokens route apart "
                      + " ".join(f"(token {t}: engine {e[t].tolist()} "
                                 f"oracle {o[t].tolist()} gap "
                                 f"{float(gap[t]):.1e})" for t in bad)
                      + f"; smallest gap {float(gap.min()):.1e}", flush=True)
            dec = rec[NL:]
            print(f"[flips] request {r.rid}: smallest gap a decode step: "
                  + " ".join(f"{min(float(dec[s * NL + l][1].min()) for l in range(NL)):.0e}"
                             for s in range(len(dec) // NL)), flush=True)
    finally:
        moe_layer.route_topk = router.route_topk
    return 0


if __name__ == "__main__":
    sys.exit(main())
