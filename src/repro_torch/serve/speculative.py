"""Self-drafting speculative decoding for the serve engine (port of
``repro/serve/speculative.py``; host-side numpy, as in JAX).

MoE decode is memory-bound: every step pays the full weight and KV
traffic to advance each sequence by one token.  Speculative decoding
amortizes that traffic by *verifying* up to ``k`` drafted tokens a step in
one static-shape forward over ``[B, k + 1]`` query positions against the
paged KV cache (``model.decode_step`` with a multi-token window, which
runs the ``paged_attention`` kernel with k + 1 queries a row), then
committing the accepted prefix plus one token from the verify logits: a
step commits between 1 and k + 1 tokens.

Two halves:

* **Drafting** (``DraftProposer``): the built-in ``NGramProposer`` is
  self-drafting (prompt-lookup decoding): the longest recent suffix
  n-gram of the request's context (prompt + committed output) is matched
  at its most recent earlier occurrence and the tokens that followed it
  are proposed.  No draft model and no extra forward.
* **Acceptance** (``greedy_verify`` / ``rejection_verify``): greedy
  acceptance is exact match against the verify argmax, so the committed
  stream equals plain greedy decode's.  At ``temperature > 0`` the
  rejection-sampling rule runs against the truncated base distribution
  (``truncated_probs_np``, the categorical ``sample_np`` draws from): the
  proposer is a point mass on the drafted token, so draft ``d`` is kept
  with probability ``p(d)``, and a rejection resamples from ``p`` with
  ``d`` removed.  The engine draws on the JAX engine's host generator
  (``default_rng(skew_seed + 101)``) in the same order, so the sampled
  streams equal JAX's.

The engine half (block growth and copy-on-write over the speculative
write range, rollback of rejected positions by masking) is in
``engine.py``.
"""
from __future__ import annotations

from typing import List, Protocol, Tuple

import numpy as np

from repro_torch.serve.sampling import truncated_probs_np


class DraftProposer(Protocol):
    """Proposes up to ``k`` candidate continuation tokens for a context."""

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        """context: committed int32 token ids (prompt + output so far);
        returns at most ``k`` drafted next tokens (possibly empty — the
        verify step still commits one real token either way)."""
        ...


class NGramProposer:
    """Prompt-lookup / n-gram self-drafting.

    Finds the longest suffix n-gram of the context (between ``min_ngram``
    and ``max_ngram`` tokens) that re-occurs earlier in the context, and
    proposes the tokens that followed its most recent earlier occurrence.
    Deterministic, draft-model-free, O(len * max_ngram) per call on small
    serving contexts.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32).reshape(-1)
        L = ctx.shape[0]
        if k < 1 or L < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            suffix = ctx[L - n:]
            # most recent earlier occurrence: scan right-to-left over
            # window starts; the match must leave >= 1 token to propose
            for i in range(L - n - 1, -1, -1):
                if np.array_equal(ctx[i:i + n], suffix):
                    return ctx[i + n:i + n + k].copy()
        return np.zeros((0,), np.int32)


_PROPOSERS = {"ngram": NGramProposer}


def make_proposer(policy: str, **kwargs) -> DraftProposer:
    """Build a draft proposer by policy name (``EngineConfig
    .speculative_policy``).  Extension point: register a class accepting
    the policy's kwargs and exposing ``propose(context, k)``."""
    try:
        cls = _PROPOSERS[policy]
    except KeyError:
        raise ValueError(
            f"unknown speculative_policy {policy!r}; "
            f"known: {sorted(_PROPOSERS)}") from None
    return cls(**kwargs)


# ----------------------------------------------------------------------
# Acceptance
# ----------------------------------------------------------------------
def greedy_verify(logits: np.ndarray, drafts: List[int]
                  ) -> Tuple[int, int]:
    """Greedy exact-match acceptance.

    ``logits``: [>= len(drafts) + 1, V] verify logits — row ``i`` scores
    the token following window position ``i`` (row 0 follows the committed
    last token, row i the i-th draft).  Drafts are accepted while they
    equal the argmax of the preceding row — exactly the token greedy
    decode would have emitted — and the first row after the accepted
    prefix contributes one committed token either way.  Returns
    ``(n_accepted, next_token)``."""
    n_acc = 0
    for d in drafts:
        if int(np.argmax(logits[n_acc])) != d:
            break
        n_acc += 1
    return n_acc, int(np.argmax(logits[n_acc]))


def rejection_verify(logits: np.ndarray, drafts: List[int],
                     rng: np.random.Generator, *, temperature: float,
                     top_k: int = 0, top_p: float = 1.0
                     ) -> Tuple[int, int]:
    """Rejection-sampling acceptance against the truncated base sampler.

    The self-drafting proposer is deterministic (q is a point mass on the
    drafted token), so draft ``d`` at position ``i`` is accepted with
    probability ``p_i(d)`` under the *truncated* base distribution, and a
    rejection draws the replacement from ``p_i`` with ``d`` removed and
    renormalized (= ``norm(max(p_i - q, 0))``).  Every committed token is
    therefore marginally distributed exactly as the base sampler's draw
    at that position.  After a fully accepted window the bonus token is a
    plain draw from the last row.  Returns ``(n_accepted, next_token)``.
    """
    n_acc = 0
    for d in drafts:
        ids, p = truncated_probs_np(logits[n_acc], temperature=temperature,
                                    top_k=top_k, top_p=top_p)
        at = np.nonzero(ids == d)[0]
        p_d = float(p[at[0]]) if at.size else 0.0
        if p_d >= 1.0 or rng.uniform() < p_d:
            n_acc += 1
            continue
        # rejected: resample from the residual (p with d zeroed); d had
        # p_d < 1 here, so at least one other candidate remains
        mask = ids != d
        resid = p[mask]
        resid = resid / resid.sum()
        return n_acc, int(ids[mask][rng.choice(resid.shape[0], p=resid)])
    ids, p = truncated_probs_np(logits[n_acc], temperature=temperature,
                                top_k=top_k, top_p=top_p)
    return n_acc, int(ids[rng.choice(p.shape[0], p=p)])
