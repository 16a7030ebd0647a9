"""Greedy token selection (the ``temperature == 0`` case of
``repro/serve/sampling.py``).  Ties go to the lowest token id, as
``jnp.argmax`` and ``np.argmax`` break them."""
from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """logits [B, V] -> int32 [B], greedy (``torch.argmax`` returns the
    first maximal index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
