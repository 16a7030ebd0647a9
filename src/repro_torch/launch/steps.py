"""Step functions assembled from a model and the optimizer (port of
``repro/launch/steps.py``).

    train_step = make_train_step(model, lr=3e-4)
    opt = adamw_init(params)
    params, opt, loss, diags = train_step(params, opt, batch)

    prefill_step = make_prefill_step(model, s_max=S + 64)
    token, caches, pos, _ = prefill_step(params, {"tokens": prompts})
    decode_step = make_decode_step(model)
    for _ in range(n):
        token, caches, pos, _ = decode_step(params, token, caches, pos)

The train step differentiates ``model.train_loss`` with respect to every
parameter leaf, in JAX's leaf order (``repro_torch.tree``), and applies
``optim.adamw_update``; with ``ParallelConfig.microbatch`` n > 1 it
splits the batch into n microbatches along its first axis, sums their
gradients in f32 and divides by n (the loss and the diagnostics are the
microbatches' means, each over all its axes), as JAX's scan does.  The
parameters stay plain tensors that require no grad: the step
differentiates aliases of them, and the update writes them in place.

Greedy decoding: each inference step returns the argmax token [B, 1]
int32 (ties to the lower id, as ``jnp.argmax``).  The slab caches are
updated in place.  On a sliding-window model this is the one-shot
windowed path: the slab is clamped to the window, the prefill keeps the
prompt's window tail at its ring slots, and each decode step writes at
its position modulo the clamped slab's length.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update


def loss_and_grads(model, params, batch, skew_key=None, skew_assign=None,
                   moe_layer_diags: bool = False):
    """(loss, diags, gradient leaves in JAX's order) of
    ``model.train_loss`` on one batch; a leaf that the loss does not reach
    gets zeros, as ``jax.grad`` gives."""
    flat, structure = tree.flatten(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, diags = model.train_loss(
            tree.unflatten(structure, leaves), batch, skew_key,
            skew_assign=skew_assign, moe_layer_diags=moe_layer_diags)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in diags.items()}, \
        list(grads)


def make_train_step(model, *, lr: float = 3e-4,
                    on_grads: Optional[Callable[[Any, Dict], None]] = None,
                    moe_layer_diags: bool = False, grid=None):
    """``train_step(params, opt, batch, skew_key=None, skew_assign=None)
    -> (params, opt, loss, diags)``; ``batch`` holds ``tokens`` and
    ``labels`` [B, S] (whisper's ``frames``, pixtral's ``patches``),
    arrays or tensors.  ``on_grads(grads, diags)``, if given, sees the
    gradient tree (the microbatches' f32 mean) before the update;
    ``moe_layer_diags`` adds each MoE layer's expert loads
    (``expert_load_layers``) to the diagnostics.  On a process ``grid``
    (``launch/grid.py``; the model built on its row's ``DistComm``)
    ``batch`` is this process's data shard, and the gradients, the loss
    and the diagnostics are averaged over the data-parallel group (the
    diagnostics as JAX's MoE layer averages its data shards') before
    the update, whose clip takes the whole model's norm."""
    n_ub = max(model.pcfg.microbatch, 1)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any],
                   skew_key=None, skew_assign=None):
        structure = tree.flatten(params)[1]
        if n_ub == 1:
            loss, diags, grads = loss_and_grads(
                model, params, batch, skew_key, skew_assign, moe_layer_diags)
        else:
            gsum = loss_sum = None
            per = []
            for i in range(n_ub):
                ub = {k: _split(v, n_ub, i) for k, v in batch.items()}
                loss_i, diags_i, g = loss_and_grads(
                    model, params, ub, skew_key, skew_assign,
                    moe_layer_diags)
                if gsum is None:
                    gsum = [torch.zeros(x.shape, dtype=torch.float32,
                                        device=x.device) for x in g]
                    loss_sum = torch.zeros((), dtype=torch.float32,
                                           device=loss_i.device)
                for acc, x in zip(gsum, g):
                    acc.add_(x.float())
                del g
                loss_sum = loss_sum + loss_i
                per.append(diags_i)
            grads = [g.div_(n_ub) for g in gsum]
            loss = loss_sum / n_ub
            # JAX's tree-map of .mean() over the stacked diagnostics: a
            # vector one collapses to a scalar too
            diags = {k: torch.stack([d[k] for d in per]).mean()
                     for k in per[0]}
        gnorm = None
        if grid is not None:
            keys = sorted(diags)
            avg = grid.average(grads + [loss] + [diags[k] for k in keys])
            grads, loss = avg[:len(grads)], avg[len(grads)]
            diags = dict(zip(keys, avg[len(grads) + 1:]))
        grad_tree = tree.unflatten(structure, grads)
        if grid is not None:
            gnorm = grid.global_norm(grad_tree)
        if on_grads is not None:
            on_grads(grad_tree, diags)
        params, opt_state = adamw_update(grad_tree, opt_state, params, lr=lr,
                                         grad_norm=gnorm)
        return params, opt_state, loss, diags
    return train_step


def _split(x, n: int, i: int):
    """Microbatch i of n along the first axis (JAX's reshape to
    (n, B / n, ...))."""
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def make_prefill_step(model, *, s_max: int, kernels: bool = True):
    """``kernels`` False: the plain branches on every device (the dry-run's
    step on ``meta``, as JAX's dry-run lowers with ``use_pallas=False``)."""
    def prefill_step(params, batch):
        logits, caches, pos, diags = model.prefill(params, batch, s_max=s_max,
                                                   kernels=kernels)
        token = logits.argmax(dim=-1)[:, None].to(torch.int32)
        return token, caches, pos, diags
    return prefill_step


def make_decode_step(model, *, kernels: bool = True):
    def decode_step(params, token, caches, pos):
        logits, caches, new_pos, diags = model.decode_step(
            params, token, caches, pos, kernels=kernels)
        new_token = logits.argmax(dim=-1)[:, None].to(torch.int32)
        return new_token, caches, new_pos, diags
    return decode_step


def optimizer_shapes(param_shapes: Any) -> AdamWState:
    """AdamW's state for a tree of parameters (or of their shapes) as
    empty ``meta`` tensors: the counterpart of
    ``jax.eval_shape(adamw_init, param_shapes)`` (``launch/dryrun``)."""
    return adamw_init(tree.tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        param_shapes))
