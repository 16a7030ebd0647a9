"""Step core of the serving engine (port of ``repro/serve/stepcore.py``):
the prefill-chunk and decode entry points and their key streams.  It
holds no scheduling state: the engine passes each call's values (a
chunk's tokens, start and last index; the batch vectors of a decode step:
tokens, per-row positions, active mask, and on the paged pool the block
table) as host values, and gets host tokens back.

With ``speculative_k = k > 0`` (paged only) the decode entry is the
``[B, k + 1]`` *verify* step instead, as in JAX: window position 0 of
each row is its committed last token, 1..k its drafts, and the step
hands back the logits ``[B, k + 1, Vp]`` at every window position (as
float32, in the same one copy to pinned host memory as the MoE
diagnostics); acceptance and sampling run on the host
(``serve/speculative.py``), so the verify step draws no Gumbel noise.
It is still one captured graph under the ``decode`` key.

Both entries are compiled once, as JAX jits them (``Entry``): on the
card, an entry's first call (``ServeEngine.warmup``, or the first chunk
or step of a ``run`` without it) runs it eagerly on a side stream and
then captures it as a CUDA graph, which every later call replays.  Every
shape is fixed when the engine is built, so one graph an entry serves
every chunk position, partial final chunk, admission, slot recycling,
block growth, preemption, re-prefill and EOS; ``jit_counts()`` counts the
graphs captured (0 on the CPU, where the entries run eagerly).  What a
graph reads lives in static device buffers (``Staged``): one int32
buffer an entry, filled by one copy from pinned host memory a call, and,
under synthetic router skew, the call's skewed assignments
``[n_moe_layers, G, t_slice, k]``, drawn before the replay by the same
``SkewKey`` generators, in the same order, as an eager call's
``route_skewed`` draws (a captured step cannot seed a generator; JAX
passes its key into the jitted step the same way).  An entry hands back
its tokens and its MoE diagnostics packed in one float32 tensor: one copy
to the host a call.

With ``temperature > 0`` the decode step samples inside the graph
(``sampling.sample_tokens``) on Gumbel noise that rides in a static
buffer, drawn before each replay on a generator seeded by (``skew_seed``,
the decode stream, the step index), as the JAX step folds its key; with
skew on too, the key splits as JAX's does, ``fold_in(key, 0)`` for the
skew draws and ``fold_in(key, 1)`` for the noise.  The prefill chunk
keeps its argmax: a prompt's first token is the host twin's draw
(``sampling.sample_np``) over the chunk's logits row, which
``prefill_logits`` copies to the host only when sampling is on.

The serving-time expert placement rides in the same static buffers: the
replica table ``[G, R]`` (prefill chunk and decode; ``serve/rebalance``)
and the residency table ``[G, W]`` (decode; ``serve/residency``) are
int32 values filled from pinned memory before each replay, so a swap or a
stage changes what a graph reads, never the graph; with residency on,
the decode step also hands back ``expert_load_layers`` in its one copy.

There is no fallback: a step that cannot be captured fails.  ``eager()``
(the counterpart of ``jax.disable_jit()``) runs every entry, the KV
store's writes included, without the graph, on the same buffers, for
comparisons on the card.

Across processes (a model over ``dispatch.DistComm``) each process draws
only its own rank's skewed assignments (``[n_moe_layers, 1, t_slice,
k]``).  gloo's collectives cannot be captured, nor can the hosted fetch:
on such a communicator an entry asked to capture raises, and the engine
runs inside ``eager()``; NCCL with the dense fetch is captured as on one
rank.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import round_up
from repro_torch.core.router import SkewKey, skew_draw, skew_probs
from repro_torch.models.transformer import moe_layer_keys
from repro_torch.serve.sampling import gumbel_, noise_width, sample_tokens

_eager = False


@contextlib.contextmanager
def eager():
    """Entries called inside run eagerly on the card, never captured or
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


def kernel_launches() -> Dict[str, int]:
    """Each kernel's launches so far, by kernel name."""
    names = ("moe_gmm", "paged_attention", "flash_attention", "schedule")
    return {n: fn.launches for n, fn in zip(names, kernel_wrappers())}


class Staged:
    """A static int32 device buffer of an entry's per-call values, filled
    by one non-blocking copy from pinned host memory a call.  The host
    side is rewritten only once the previous copy from it has run."""

    def __init__(self, n: int, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
        self.dev = torch.zeros((n,), dtype=torch.int32, device=device)
        self._copied = torch.cuda.Event() if cuda else None

    def fill(self) -> np.ndarray:
        """The host buffer, free to be written."""
        if self._copied is not None:
            self._copied.synchronize()
        return self.host.numpy()

    def push(self) -> None:
        self.dev.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class Entry:
    """One compiled entry (the counterpart of a ``jax.jit`` function):
    ``fn(*args)`` reads its per-call values from static buffers.  On the
    CPU, or inside ``eager()``, a call runs ``fn``.  On the card the first
    call warms ``fn`` eagerly on a side stream (its result is that call's)
    and captures it; every later call replays the graph on the same
    arguments and returns the graph's static outputs.  The capture
    launches nothing, so the wrappers' launch counts are put back and
    each replay adds the launches the capture recorded."""

    def __init__(self, fn: Callable, device: torch.device,
                 refuse: Optional[str] = None):
        self.fn, self.device = fn, device
        self.refuse = refuse          # why this entry cannot be captured
        self.graph = None
        self._args: Tuple = ()
        self._out = None
        self._launches: Tuple[int, ...] = ()

    @property
    def captures(self) -> int:
        return int(self.graph is not None)

    def __call__(self, *args):
        if self.device.type != "cuda" or _eager:
            return self.fn(*args)
        if self.graph is None:
            if self.refuse:
                raise RuntimeError(f"cannot capture this entry: "
                                   f"{self.refuse}; run it inside "
                                   f"stepcore.eager()")
            return self._capture(*args)
        if any(a is not b for a, b in zip(args, self._args)):
            raise RuntimeError("a captured entry reads the tensors it was "
                               "captured on")
        self.graph.replay()
        for fn, n in zip(kernel_wrappers(), self._launches):
            fn.launches += n
        return self._out

    def _capture(self, *args):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*args)
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
                self._out = self.fn(*args)
        finally:
            if collecting:
                gc.enable()
        self._launches = tuple(fn.launches - n
                               for fn, n in zip(wrappers, before))
        for fn, n in zip(wrappers, before):
            fn.launches = n
        self.graph, self._args = graph, args
        return out


class StepCore:
    def __init__(self, model, ecfg, *, blocks_per_slot: int = 0):
        self.model = model
        self.ecfg = ecfg
        self.device = dev = model.device
        cfg = model.cfg
        if cfg.padded_vocab > 2 ** 24:
            raise ValueError("token ids travel to the host as float32, "
                             "exact below 2**24")
        self.skew = bool(cfg.is_moe and cfg.moe.router_skew > 0)
        base = SkewKey((ecfg.skew_seed,))
        self.pf_key, self.dec_key = base.fold_in(0), base.fold_in(1)
        B, C = self.B, self.C = ecfg.max_slots, ecfg.prefill_chunk
        self.bps = blocks_per_slot if ecfg.paged else 0
        # the verify window: k + 1 query positions a row
        self.spec = ecfg.paged and ecfg.speculative_k > 0
        S = self.S = ecfg.speculative_k + 1 if self.spec else 1
        G = model.moe_spec_decode.ep_degree if cfg.is_moe else 1
        self.G, self.R = G, ecfg.replica_slots
        # the ranks whose skewed assignments this process draws; under
        # tensor-parallel MoE every rank routes every token on the layer's
        # own key (None: no rank fold), as JAX's tp_moe_block draws
        tp = cfg.is_moe and model.moe_spec.tp_mode
        self.ranks_here = ((None,) if tp else
                           getattr(model.comm, "ranks_here", (0,)))
        self.W = ecfg.resident_experts // G
        n_rep, n_res = G * self.R, G * self.W
        # decode: tokens [B, S] | positions | active | replica table |
        # residency table | block table; prefill chunk: tokens | start |
        # last | replica table
        self._pos_at = B * S
        self._rep_at = B * S + 2 * B
        self._res_at = self._rep_at + n_rep
        self._bt_at = self._res_at + n_res
        self._dec_in = Staged(self._bt_at + B * self.bps, dev)
        self._pf_in = Staged(C + 2 + n_rep, dev)
        self._h_out: Dict[int, torch.Tensor] = {}
        self._skew = self._pf_skew = None
        if self.skew:
            moe = cfg.moe
            self._moe_keys = moe_layer_keys(cfg)

            def draws(tokens):      # one slice a rank here, as moe_block
                t = tokens if tp else round_up(max(tokens, G), G) // G
                return torch.zeros((len(self._moe_keys), len(self.ranks_here),
                                    t, moe.num_experts_per_tok),
                                   dtype=torch.int32, device=dev)
            self._skew, self._pf_skew = draws(B * S), draws(C)
            padded = (moe.num_experts if tp
                      else model.moe_spec_decode.topo.padded_experts)
            self._probs = skew_probs(moe.num_experts, padded,
                                     moe.router_skew,
                                     moe.router_skew_experts, dev)
        # sampling: the decode step's Gumbel noise [B, candidates] (none for
        # the verify step, whose tokens are drawn on the host) and the host
        # twin's generator for first tokens and verify draws (the JAX
        # engine's seed)
        self.sample = ecfg.temperature > 0
        self._noise: Optional[torch.Tensor] = None
        self.samp_rng: Optional[np.random.Generator] = None
        if self.sample:
            self.samp_rng = np.random.default_rng(ecfg.skew_seed + 101)
        if self.sample and not self.spec:
            self._noise = torch.zeros(
                (B, noise_width(cfg.padded_vocab, ecfg.top_k)),
                dtype=torch.float32, device=dev)
        # host seconds spent on skew draws (by entry) and on the decode
        # step's sampling noise ("noise"), and calls
        self.predraw_s = {"decode": 0.0, "prefill_chunk": 0.0, "noise": 0.0}
        self.predraw_calls = {"decode": 0, "prefill_chunk": 0, "noise": 0}
        self._layouts: Dict[str, list] = {}    # packed diagnostics, by entry
        self._last_packed = "decode"
        # the lambdas look the step up at each call (tests wrap it)
        comm = model.comm
        refuse = (None if getattr(comm, "capturable", True) else
                  f"the MoE blocks' communicator ({comm.describe()}) "
                  f"cannot be captured")
        self.decode_entry = Entry(lambda p, pool: self._step(p, pool), dev,
                                  refuse)
        self.prefill_entry = Entry(
            lambda p, scratch: self._prefill_step(p, scratch), dev, refuse)
        # the JAX engine's fused_paged_attention makes its chunks and paged
        # steps strict: a branch without a kernel raises
        self._fused_attn = True if ecfg.fused_paged_attention else None
        self._pf_packed: Optional[torch.Tensor] = None
        self._pf_logits: Optional[torch.Tensor] = None   # the last chunk's
        self.logits: Optional[torch.Tensor] = None  # the last decode's

    def next_key(self, stream: SkewKey, idx: int) -> Optional[SkewKey]:
        return stream.fold_in(idx) if self.skew else None

    def jit_counts(self) -> Dict[str, int]:
        """Captured entries, by the JAX engine's names."""
        return {"prefill_chunk": self.prefill_entry.captures,
                "decode": self.decode_entry.captures}

    def predraw_ms(self, entry: str) -> float:
        """Host ms a call spent on ``entry``'s skew pre-draws ("decode",
        "prefill_chunk") or on the decode step's noise ("noise")."""
        return (self.predraw_s[entry] * 1e3
                / max(self.predraw_calls[entry], 1))

    # ------------------------------------------------------------------
    def prefill(self, params, chunk: np.ndarray, scratch, start: int,
                last: int, chunk_idx: int,
                replica_ids: Optional[np.ndarray] = None) -> None:
        """Enqueue one [1, C] prompt chunk at ``start`` into the scratch
        (the engine's ``chunk_idx``-th), whose logits are read at
        ``last``, with the replica table ``replica_ids`` [G, R];
        ``prefill_result`` reads what it hands back."""
        C = self.C
        h = self._pf_in.fill()
        h[:C] = np.asarray(chunk).reshape(C)
        h[C], h[C + 1] = start, last
        if self.R:
            h[C + 2:] = np.asarray(replica_ids).reshape(-1)
        self._pf_in.push()
        self._predraw(chunk_idx, "prefill_chunk")
        self._pf_packed, self._pf_logits = self.prefill_entry(params, scratch)

    def prefill_result(self) -> Tuple[int, np.ndarray]:
        """The last chunk's greedy token at ``last`` and its packed MoE
        diagnostics (``unpack``), through one copy to the host."""
        packed = self._to_host(self._pf_packed)
        return int(packed[0]), packed[1:]

    def prefill_logits(self) -> np.ndarray:
        """The last chunk's logits row at ``last`` [padded vocab] on the
        host (float32), for the host sampler: one more copy, made only
        for a finished prompt when sampling is on."""
        return self._to_host(self._pf_logits[0])

    def _prefill_step(self, params, scratch
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prefill chunk on the static buffers: what the graph holds."""
        C, d = self.C, self._pf_in.dev
        rep = d[C + 2:].view(self.G, self.R) if self.R else None
        logits, _, _, diags = self.model.prefill_chunk(
            params, d[:C].view(1, C), scratch, d[C], d[C + 1],
            skew_assign=self._pf_skew, moe_replica_ids=rep,
            fused_attention=self._fused_attn)
        packed = torch.cat([sample_tokens(logits).float(),
                            self._pack(diags, "prefill_chunk")])
        return packed, logits

    def _pack(self, diags: Dict[str, torch.Tensor],
              entry: str) -> torch.Tensor:
        self._layouts[entry] = [(k, tuple(v.shape)) for k, v in diags.items()]
        self._last_packed = entry
        if not diags:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return torch.cat([v.reshape(-1).float() for v in diags.values()])

    def unpack(self, packed: np.ndarray,
               entry: Optional[str] = None) -> Dict[str, np.ndarray]:
        """A packed diagnostics vector of ``entry`` ("prefill_chunk" or
        "decode"; default: the entry packed last) -> {key: array of its
        shape}."""
        out, i = {}, 0
        for k, shape in self._layouts[entry or self._last_packed]:
            n = int(np.prod(shape))
            out[k] = packed[i:i + n].reshape(shape)
            i += n
        return out

    # ------------------------------------------------------------------
    def decode(self, params, tok: np.ndarray, pool, pos: np.ndarray,
               block_table: Optional[np.ndarray], active: np.ndarray,
               step_idx: int, replica_ids: Optional[np.ndarray] = None,
               residency_ids: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One decode step of every slot (the engine's ``step_idx``-th
        step) on the paged pool through ``block_table`` or, without one,
        on the slab at each row's own position, with the replica table
        [G, R] and the residency table [G, W].  Returns the next tokens
        [B] (greedy, or sampled on this step's noise) and the packed MoE
        diagnostics (``unpack``), on the host.  With speculation on,
        ``tok`` is the verify window [B, k + 1] and the first value is the
        window's logits [B, k + 1, Vp] (float32) instead."""
        B, S = self.B, self.S
        h = self._dec_in.fill()
        h[:B * S] = np.asarray(tok).reshape(B * S)
        h[B * S:B * S + B] = pos
        h[B * S + B:self._rep_at] = active
        if self.R:
            h[self._rep_at:self._res_at] = np.asarray(replica_ids).reshape(-1)
        if self.W:
            h[self._res_at:self._bt_at] = np.asarray(
                residency_ids).reshape(-1)
        if self.bps:
            h[self._bt_at:] = np.asarray(block_table).reshape(-1)
        self._dec_in.push()
        self._predraw(step_idx, "decode")
        if self._noise is not None:
            self._draw_noise(step_idx)
        packed, self.logits = self.decode_entry(params, pool)
        packed = self._to_host(packed)
        if self.spec:
            n = self.logits.numel()
            return packed[:n].reshape(self.logits.shape), packed[n:]
        return packed[:B].astype(np.int32), packed[B:]

    def _predraw(self, idx: int, entry: str = "decode") -> None:
        """The skewed assignments of the ``idx``-th call of ``entry`` into
        its static buffer: for MoE layer m and each rank g this process
        runs, the draws ``route_skewed`` makes on ``key / idx / layer /
        rank``."""
        if not self.skew:
            return
        t0 = time.perf_counter()
        buf, key = ((self._pf_skew, self.pf_key) if entry == "prefill_chunk"
                    else (self._skew, self.dec_key))
        key = key.fold_in(idx)
        if entry == "decode" and self.sample:
            key = key.fold_in(0)          # JAX's split: 0 skew, 1 sampling
        T, k = buf.shape[2], buf.shape[3]
        for m, layer in enumerate(self._moe_keys):
            lk = key.fold_in(layer)
            for i, g in enumerate(self.ranks_here):
                gk = lk if g is None else lk.fold_in(g)
                buf[m, i].copy_(skew_draw(gk.generator(self.device),
                                          self._probs, T, k))
        self.predraw_s[entry] += time.perf_counter() - t0
        self.predraw_calls[entry] += 1

    def _draw_noise(self, idx: int) -> None:
        """The ``idx``-th decode step's Gumbel noise into its static
        buffer (the key JAX's step samples on: the decode stream's
        ``idx``, folded with 1 when the skew draws share it)."""
        t0 = time.perf_counter()
        key = self.dec_key.fold_in(idx)
        if self.skew:
            key = key.fold_in(1)
        gumbel_(self._noise, key.generator(self.device))
        self.predraw_s["noise"] += time.perf_counter() - t0
        self.predraw_calls["noise"] += 1

    def _step(self, params, pool):
        """The decode (or verify) step on the static buffers: what the
        graph holds."""
        B, S, d = self.B, self.S, self._dec_in.dev
        kw = {}
        if self.bps:
            kw = dict(block_table=d[self._bt_at:].view(B, self.bps),
                      block_size=self.ecfg.kv_block_size,
                      fused_attention=self._fused_attn)
        if self.R:
            kw["moe_replica_ids"] = d[self._rep_at:self._res_at].view(
                self.G, self.R)
        if self.W:
            kw.update(moe_layer_diags=True,
                      moe_residency_ids=d[self._res_at:self._bt_at].view(
                          self.G, self.W))
        pos = d[self._pos_at:self._pos_at + B]
        logits, _, _, diags = self.model.decode_step(
            params, d[:B * S].view(B, S), pool, pos,
            active_mask=d[self._pos_at + B:self._rep_at].to(torch.bool),
            moe_policy=self.ecfg.moe_policy, skew_assign=self._skew, **kw)
        if self.spec:
            # no sampling in the verify step: its logits go to the host
            packed = torch.cat([logits.float().reshape(-1),
                                self._pack(diags, "decode")])
            return packed, logits
        e = self.ecfg
        nxt = sample_tokens(logits, self._noise, temperature=e.temperature,
                            top_k=e.top_k, top_p=e.top_p)
        packed = torch.cat([nxt.float(), self._pack(diags, "decode")])
        return packed, logits

    def _to_host(self, packed: torch.Tensor) -> np.ndarray:
        """One copy to the host, then one stream sync (the call's result
        is needed now)."""
        if self.device.type != "cuda":
            return packed.numpy().copy()
        buf = self._h_out.get(packed.numel())
        if buf is None:
            buf = self._h_out[packed.numel()] = torch.empty(
                packed.shape, dtype=torch.float32, pin_memory=True)
        buf.copy_(packed, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return buf.numpy().copy()
