"""Inference step functions assembled from a model (port of the prefill
and decode steps of ``repro/launch/steps.py``; the training step is not
ported yet).

    prefill_step = make_prefill_step(model, s_max=S + 64)
    token, caches, pos, _ = prefill_step(params, {"tokens": prompts})
    decode_step = make_decode_step(model)
    for _ in range(n):
        token, caches, pos, _ = decode_step(params, token, caches, pos)

Greedy: each step returns the argmax token [B, 1] int32 (ties to the
lower id, as ``jnp.argmax``).  The slab caches are updated in place.  On
a sliding-window model this is the one-shot windowed path: the slab is
clamped to the window, the prefill keeps the prompt's window tail at its
ring slots, and each decode step writes at its position modulo the
clamped slab's length.
"""
from __future__ import annotations

import torch


def make_prefill_step(model, *, s_max: int):
    def prefill_step(params, batch):
        logits, caches, pos, diags = model.prefill(params, batch, s_max=s_max)
        token = logits.argmax(dim=-1)[:, None].to(torch.int32)
        return token, caches, pos, diags
    return prefill_step


def make_decode_step(model):
    def decode_step(params, token, caches, pos):
        logits, caches, new_pos, diags = model.decode_step(
            params, token, caches, pos)
        new_token = logits.argmax(dim=-1)[:, None].to(torch.int32)
        return new_token, caches, new_pos, diags
    return decode_step
