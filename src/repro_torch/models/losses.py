"""Vocabulary head (port of ``repro/models/losses.py::logits_head``)."""
from __future__ import annotations

import torch


def logits_head(hidden_last: torch.Tensor, w_vocab: torch.Tensor, *,
                real_vocab: int, softcap: float = 0.0) -> torch.Tensor:
    """hidden_last [B, d] -> f32 logits [B, Vp] (padded vocab masked)."""
    logits = hidden_last.float() @ w_vocab.float().T
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    Vp = w_vocab.shape[0]
    pad = torch.arange(Vp, device=logits.device)[None, :] >= real_vocab
    return logits.masked_fill(pad, -1e30)
