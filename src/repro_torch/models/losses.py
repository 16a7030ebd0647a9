"""Vocabulary head and chunked cross-entropy (port of
``repro/models/losses.py``: ``logits_head``, ``chunked_softmax_xent``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _head_logits(h: torch.Tensor, w_vocab: torch.Tensor, real_vocab: int,
                 softcap: float) -> torch.Tensor:
    """f32 logits of h [..., d] over w_vocab [Vp, d], the softcap, and the
    padded vocabulary masked to -1e30."""
    logits = h.float() @ w_vocab.float().T
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    Vp = w_vocab.shape[0]
    pad = torch.arange(Vp, device=logits.device) >= real_vocab
    return logits.masked_fill(pad, -1e30)


def logits_head(hidden_last: torch.Tensor, w_vocab: torch.Tensor, *,
                real_vocab: int, softcap: float = 0.0) -> torch.Tensor:
    """hidden_last [B, d] -> f32 logits [B, Vp] (padded vocab masked)."""
    return _head_logits(hidden_last, w_vocab, real_vocab, softcap)


def _chunk_nll(h: torch.Tensor, lab: torch.Tensor, w_vocab: torch.Tensor,
               real_vocab: int, softcap: float, ignore_id: int):
    """One chunk's summed NLL and count of valid labels (h [B, C, d],
    lab [B, C]): the label logit by a masked reduce over the vocabulary,
    as JAX takes it."""
    logits = _head_logits(h, w_vocab, real_vocab, softcap)
    lse = torch.logsumexp(logits, dim=-1)
    Vp = w_vocab.shape[0]
    onehot = (torch.arange(Vp, device=lab.device)[None, None, :]
              == lab.clamp(0, Vp - 1)[..., None])
    lab_logit = torch.where(onehot, logits, 0.0).sum(dim=-1)
    valid = lab != ignore_id
    nll = torch.where(valid, lse - lab_logit, 0.0)
    return nll.sum(), valid.sum().to(torch.int32)


def chunked_softmax_xent(hidden: torch.Tensor, w_vocab: torch.Tensor,
                         labels: torch.Tensor, *, real_vocab: int,
                         chunk: int = 2048, softcap: float = 0.0,
                         ignore_id: int = -1) -> torch.Tensor:
    """hidden [B, S, d]; w_vocab [Vp, d]; labels [B, S] -> the mean NLL
    over the labels that are not ``ignore_id``, in f32.  The sequence goes
    through in chunks (a ragged last chunk padded with ``ignore_id``), and
    under grad mode each chunk runs under ``torch.utils.checkpoint``, so
    its [B, chunk, Vp] logits are recomputed in backward, not stored (JAX's
    ``jax.checkpoint`` on its scan step)."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    n = -(-S // chunk)
    Sp = n * chunk
    if Sp != S:
        hidden = F.pad(hidden, (0, 0, 0, Sp - S))
        labels = F.pad(labels, (0, Sp - S), value=ignore_id)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c in range(n):
        args = (hidden[:, c * chunk:(c + 1) * chunk],
                labels[:, c * chunk:(c + 1) * chunk], w_vocab, real_vocab,
                softcap, ignore_id)
        if torch.is_grad_enabled():
            s, k = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            s, k = _chunk_nll(*args)
        nll_sum = nll_sum + s
        count = count + k
    return nll_sum / torch.clamp(count, min=1)
