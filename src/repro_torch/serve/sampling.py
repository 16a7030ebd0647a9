"""Static-shape token sampling for the serve engine (port of
``repro/serve/sampling.py``).

Greedy decoding is the ``temperature == 0`` case; otherwise logits are
temperature-scaled and drawn from, optionally truncated to the ``top_k``
largest and/or to the nucleus (the smallest set of tokens whose
cumulative probability reaches ``top_p``).  All three knobs are fixed
when the engine is built, so sampling changes which single graph an
entry captures, never how many.

``sample_tokens`` is the decode step's sampler, on the device and inside
the captured step.  ``jax.random.categorical`` draws
``argmax(gumbel(key, shape) + logits)``; a captured step cannot seed a
generator, so the port takes that Gumbel draw as a tensor (``noise``),
drawn before the replay (``gumbel_``), of the shape JAX draws it in
(``noise_width``).  Ties keep the lowest token ids first, as
``jax.lax.top_k`` orders them: the candidates come from a stable
descending sort, never from ``torch.topk``, whose tie order on CUDA is
not defined.

``sample_np`` is its host twin, used for the one first token a finished
prefill emits (numpy only, a copy of the reference's).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def noise_width(vocab: int, top_k: int) -> int:
    """Columns of the Gumbel draw ``sample_tokens`` reads: the candidates
    it samples among (every token, or the ``top_k`` largest)."""
    top_k = min(top_k, vocab)
    return top_k if top_k > 0 else vocab


def gumbel_(buf: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill ``buf`` in place with standard Gumbel noise from ``gen``, as
    ``jax.random.gumbel`` draws it: ``-log(-log(u))``, u uniform in
    [tiny, 1)."""
    tiny = torch.finfo(buf.dtype).tiny
    return buf.uniform_(generator=gen).clamp_(min=tiny).log_().neg_() \
        .log_().neg_()


def nucleus_mask(sorted_probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep-mask over probabilities sorted descending along the last axis:
    True for the smallest prefix whose cumulative probability reaches
    ``top_p``.  The top token is always kept."""
    cum = torch.cumsum(sorted_probs, dim=-1)
    return (cum - sorted_probs) < top_p


def sample_tokens(logits: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  *, temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """logits [B, V] -> int32 [B].  Greedy when ``noise`` is None or
    ``temperature <= 0`` (``torch.argmax`` returns the first maximal
    index, as ``jnp.argmax``); else the softmax(logits / temperature)
    draw that ``noise`` [B, noise_width(V, top_k)] picks, truncated to
    the ``top_k`` largest logits when ``top_k > 0`` and to the ``top_p``
    nucleus (within the top-k candidates) when ``top_p < 1``."""
    if noise is None or temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    V = logits.shape[-1]
    if top_p < 1.0 or top_k > 0:
        # candidates in descending order, equal values by ascending index
        vals, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
        k = noise_width(V, top_k)
        vals, idx = vals[..., :k], idx[..., :k]
        if top_p < 1.0:
            keep = nucleus_mask(torch.softmax(vals, dim=-1), top_p)
            vals = vals.masked_fill(~keep, float("-inf"))
        choice = torch.argmax(noise + vals, dim=-1, keepdim=True)
        return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)
    return torch.argmax(noise + scaled, dim=-1).to(torch.int32)


def truncated_probs_np(logits_row: np.ndarray, *, temperature: float,
                       top_k: int = 0, top_p: float = 1.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The truncated categorical ``sample_np`` draws from, materialized:
    ``(candidate token ids, their probabilities)`` for one row of logits
    at ``temperature > 0``.  Ties keep the lowest indices, as
    ``sample_tokens`` does (stable sorts, never ``np.argpartition``)."""
    x = np.asarray(logits_row, np.float64) / temperature
    top_k = min(top_k, x.shape[0])          # oversized k = full vocab
    if top_k > 0:
        keep = np.argsort(-x, kind="stable")[:top_k]
        x = x[keep]
    else:
        keep = np.arange(x.shape[0])
    if top_p < 1.0:
        order = np.argsort(-x, kind="stable")
        keep, x = keep[order], x[order]
        p = np.exp(x - x.max())
        p /= p.sum()
        inside = (np.cumsum(p) - p) < top_p
        keep, x = keep[inside], x[inside]
    p = np.exp(x - x.max())
    p /= p.sum()
    return keep, p


def sample_np(logits_row: np.ndarray, rng: Optional[np.random.Generator], *,
              temperature: float = 0.0, top_k: int = 0,
              top_p: float = 1.0) -> int:
    """Host-side twin of ``sample_tokens`` for one row of logits."""
    logits_row = np.asarray(logits_row, np.float64)
    if rng is None or temperature <= 0:
        return int(np.argmax(logits_row))
    keep, p = truncated_probs_np(logits_row, temperature=temperature,
                                 top_k=top_k, top_p=top_p)
    return int(keep[rng.choice(p.shape[0], p=p)])
