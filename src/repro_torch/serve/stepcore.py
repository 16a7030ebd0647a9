"""Step core of the serving engine (port of ``repro/serve/stepcore.py``):
the prefill-chunk and decode entry points.  It holds no scheduling state: the
engine passes the batch vectors (tokens, per-row positions, active mask,
and on the paged pool the block table) each call, as host numpy arrays,
and gets host tokens back from decode.  Steps run eagerly; capturing the
decode step as a CUDA graph is a later change."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.router import SkewKey
from repro_torch.serve.sampling import sample_tokens


class StepCore:
    def __init__(self, model, ecfg):
        self.model = model
        self.ecfg = ecfg
        self.device = model.device
        cfg = model.cfg
        self.skew = bool(cfg.is_moe and cfg.moe.router_skew > 0)
        base = SkewKey((ecfg.skew_seed,))
        self.pf_key, self.dec_key = base.fold_in(0), base.fold_in(1)

    def next_key(self, stream: SkewKey, idx: int) -> Optional[SkewKey]:
        return stream.fold_in(idx) if self.skew else None

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def prefill(self, params, chunk: np.ndarray, scratch, start: int,
                last: int, chunk_idx: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One [1, C] prompt chunk at ``start`` into the scratch (the
        engine's ``chunk_idx``-th); returns the logits at ``last`` (on the
        device) and the MoE diagnostics."""
        logits, _, _, diags = self.model.prefill_chunk(
            params, self._t(chunk), scratch, start, last,
            skew_key=self.next_key(self.pf_key, chunk_idx))
        return logits, diags

    def decode(self, params, tok: np.ndarray, pool, pos: np.ndarray,
               block_table: Optional[np.ndarray], active: np.ndarray,
               step_idx: int
               ) -> Tuple[np.ndarray, Dict[str, torch.Tensor]]:
        """One decode step of every slot (the engine's ``step_idx``-th
        step) on the paged pool through ``block_table`` or, without one,
        on the slab at each row's own position; greedy next tokens on the
        host."""
        kw = {}
        if block_table is not None:
            kw = dict(block_table=self._t(block_table),
                      block_size=self.ecfg.kv_block_size)
        logits, _, _, diags = self.model.decode_step(
            params, self._t(tok), pool, self._t(pos),
            skew_key=self.next_key(self.dec_key, step_idx),
            active_mask=self._t(active), moe_policy=self.ecfg.moe_policy,
            **kw)
        return sample_tokens(logits).cpu().numpy(), diags
