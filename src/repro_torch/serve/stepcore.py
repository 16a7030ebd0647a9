"""Step core of the serving engine (port of ``repro/serve/stepcore.py``):
the prefill-chunk and decode entry points and their key streams.  It
holds no scheduling state: the engine passes the batch vectors (tokens,
per-row positions, active mask, and on the paged pool the block table)
each call, as host numpy arrays, and gets host tokens back from decode.

The decode entry is compiled once, as JAX compiles its jitted step: on
the card, the first decode call (``ServeEngine.warmup``, or the first
step of a ``run`` without it) runs the step eagerly on a side stream and
then captures it as a CUDA graph, which every later call replays.  Every
shape is fixed when the engine is built, so one graph serves every
admission, slot recycling, block growth, preemption and EOS;
``jit_counts()["decode"]`` counts the graphs captured (0 on the CPU,
where the step runs eagerly).  What the graph reads lives in static
device buffers: one int32 buffer of the batch vectors, filled by one
copy from pinned host memory a step, and, under synthetic router skew,
the step's skewed assignments ``[n_moe_layers, G, t_slice, k]``, drawn
before the replay by the same ``SkewKey`` generators, in the same order,
as an eager step's ``route_skewed`` draws (a captured step cannot seed a
generator; JAX passes its key into the jitted step the same way).  The
step hands back its greedy tokens and its MoE diagnostics packed in one
float32 tensor: two copies to the host a step.

There is no fallback: a step that cannot be captured fails.  ``eager()``
(the counterpart of ``jax.disable_jit()``) runs the same step without
the graph, on the same buffers, for comparisons on the card.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import round_up
from repro_torch.core.router import SkewKey, skew_draw, skew_probs
from repro_torch.models.transformer import moe_layer_keys
from repro_torch.serve.sampling import sample_tokens

_eager = False


@contextlib.contextmanager
def eager():
    """Decode steps inside run eagerly on the card, never captured or
    replayed (the counterpart of ``jax.disable_jit()``)."""
    global _eager
    prev, _eager = _eager, True
    try:
        yield
    finally:
        _eager = prev


def kernel_wrappers():
    """The wrappers whose ``launches`` count kernel launches."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_gmm import ops as gmm
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.schedule import ops as sched
    return (gmm.moe_gmm, pa.paged_attention, fa.flash_attention,
            sched.rebalance)


class StepCore:
    def __init__(self, model, ecfg, *, blocks_per_slot: int = 0):
        self.model = model
        self.ecfg = ecfg
        self.device = dev = model.device
        cfg = model.cfg
        self.skew = bool(cfg.is_moe and cfg.moe.router_skew > 0)
        base = SkewKey((ecfg.skew_seed,))
        self.pf_key, self.dec_key = base.fold_in(0), base.fold_in(1)
        B = self.B = ecfg.max_slots
        self.bps = blocks_per_slot if ecfg.paged else 0
        # the batch vectors: tokens | positions | active | block table
        n_in = 3 * B + B * self.bps
        cuda = dev.type == "cuda"
        self._h_in = torch.zeros((n_in,), dtype=torch.int32, pin_memory=cuda)
        self._d_in = torch.zeros((n_in,), dtype=torch.int32, device=dev)
        self._h_next = torch.zeros((B,), dtype=torch.int32, pin_memory=cuda)
        self._skew = None
        if self.skew:
            spec, topo = model.moe_spec_decode, model.moe_spec_decode.topo
            moe = spec.moe
            G = topo.num_ranks
            self._moe_keys = moe_layer_keys(cfg)
            self._t_slice = round_up(max(B, G), G) // G
            self._skew = torch.zeros(
                (len(self._moe_keys), G, self._t_slice,
                 moe.num_experts_per_tok), dtype=torch.int32, device=dev)
            self._probs = skew_probs(moe.num_experts, topo.padded_experts,
                                     moe.router_skew,
                                     moe.router_skew_experts, dev)
        self.predraw_s = 0.0          # host seconds spent on skew draws
        self.predraw_steps = 0
        self._layout: List[Tuple[str, Tuple[int, ...]]] = []
        self._graph = None
        self._bound = None            # (params, pool) the graph reads
        self._out = None              # the graph's outputs
        self._launch_delta: Tuple[int, ...] = ()
        self._h_diag = None
        self.logits: Optional[torch.Tensor] = None  # the last decode's

    def next_key(self, stream: SkewKey, idx: int) -> Optional[SkewKey]:
        return stream.fold_in(idx) if self.skew else None

    def jit_counts(self) -> Dict[str, int]:
        """Captured entries, by the JAX engine's names."""
        return {"decode": int(self._graph is not None)}

    # ------------------------------------------------------------------
    def prefill(self, params, chunk: np.ndarray, scratch, start: int,
                last: int, chunk_idx: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One [1, C] prompt chunk at ``start`` into the scratch (the
        engine's ``chunk_idx``-th), eagerly; returns the logits at
        ``last`` (on the device) and the MoE diagnostics."""
        logits, _, _, diags = self.model.prefill_chunk(
            params, torch.as_tensor(chunk, device=self.device), scratch,
            start, last, skew_key=self.next_key(self.pf_key, chunk_idx))
        return logits, diags

    def host_diags(self, diags: Dict[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
        """Device diagnostics on the host, through one packed copy."""
        return self.unpack(self._pack(diags).cpu().numpy())

    def _pack(self, diags: Dict[str, torch.Tensor]) -> torch.Tensor:
        self._layout = [(k, tuple(v.shape)) for k, v in diags.items()]
        if not diags:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return torch.cat([v.reshape(-1).float() for v in diags.values()])

    def unpack(self, packed: np.ndarray) -> Dict[str, np.ndarray]:
        """A packed diagnostics vector -> {key: array of its shape}."""
        out, i = {}, 0
        for k, shape in self._layout:
            n = int(np.prod(shape))
            out[k] = packed[i:i + n].reshape(shape)
            i += n
        return out

    # ------------------------------------------------------------------
    def decode(self, params, tok: np.ndarray, pool, pos: np.ndarray,
               block_table: Optional[np.ndarray], active: np.ndarray,
               step_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """One decode step of every slot (the engine's ``step_idx``-th
        step) on the paged pool through ``block_table`` or, without one,
        on the slab at each row's own position.  Returns the greedy next
        tokens [B] and the packed MoE diagnostics (``unpack``), on the
        host."""
        B = self.B
        h = self._h_in.numpy()
        h[:B] = np.asarray(tok).reshape(B)
        h[B:2 * B] = pos
        h[2 * B:3 * B] = active
        if self.bps:
            h[3 * B:] = np.asarray(block_table).reshape(-1)
        self._d_in.copy_(self._h_in, non_blocking=True)
        self._predraw(step_idx)
        if self.device.type != "cuda" or _eager:
            nxt, self.logits, packed = self._step(params, pool)
        elif self._graph is None:
            nxt, self.logits, packed = self._capture(params, pool)
        else:
            if self._bound[0] is not params or self._bound[1] is not pool:
                raise RuntimeError("the captured decode step reads the "
                                   "params and pool it was captured on")
            self._graph.replay()
            for fn, n in zip(kernel_wrappers(), self._launch_delta):
                fn.launches += n
            nxt, self.logits, packed = self._out
        return self._to_host(nxt, packed)

    def _predraw(self, step_idx: int) -> None:
        """This step's skewed assignments into the static buffer: for MoE
        layer m and rank g, the draws ``route_skewed`` makes on
        ``dec_key / step / layer / rank``."""
        if not self.skew:
            return
        t0 = time.perf_counter()
        key = self.dec_key.fold_in(step_idx)
        k = self._skew.shape[-1]
        for m, layer in enumerate(self._moe_keys):
            lk = key.fold_in(layer)
            for g in range(self._skew.shape[1]):
                self._skew[m, g].copy_(skew_draw(
                    lk.fold_in(g).generator(self.device), self._probs,
                    self._t_slice, k))
        self.predraw_s += time.perf_counter() - t0
        self.predraw_steps += 1

    def _step(self, params, pool):
        """The decode step on the static buffers: what the graph holds."""
        B, d = self.B, self._d_in
        kw = {}
        if self.bps:
            kw = dict(block_table=d[3 * B:].view(B, self.bps),
                      block_size=self.ecfg.kv_block_size)
        logits, _, _, diags = self.model.decode_step(
            params, d[:B].view(B, 1), pool, d[B:2 * B],
            active_mask=d[2 * B:3 * B].to(torch.bool),
            moe_policy=self.ecfg.moe_policy, skew_assign=self._skew, **kw)
        return sample_tokens(logits), logits, self._pack(diags)

    def _capture(self, params, pool):
        """Warm the step eagerly on a side stream (its result is this
        step's), then capture it.  The capture launches nothing, so the
        wrappers' launch counts are put back and each replay adds the
        launches the capture recorded."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._step(params, pool)
        cur.wait_stream(side)
        wrappers = kernel_wrappers()
        before = [fn.launches for fn in wrappers]
        graph = torch.cuda.CUDAGraph()
        # a dead graph's destructor frees its graph, which a capture in
        # progress forbids: collect the dead first, and let no collection
        # run inside the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._out = self._step(params, pool)
        finally:
            if collecting:
                gc.enable()
        self._launch_delta = tuple(fn.launches - n
                                   for fn, n in zip(wrappers, before))
        for fn, n in zip(wrappers, before):
            fn.launches = n
        self._graph, self._bound = graph, (params, pool)
        return out

    def _to_host(self, nxt: torch.Tensor, packed: torch.Tensor
                 ) -> Tuple[np.ndarray, np.ndarray]:
        if self.device.type != "cuda":
            return nxt.numpy().copy(), packed.numpy().copy()
        if self._h_diag is None or self._h_diag.shape != packed.shape:
            self._h_diag = torch.empty(packed.shape, dtype=torch.float32,
                                       pin_memory=True)
        self._h_next.copy_(nxt, non_blocking=True)
        self._h_diag.copy_(packed, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._h_next.numpy().copy(), self._h_diag.numpy().copy()
