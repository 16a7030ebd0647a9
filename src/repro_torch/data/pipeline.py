"""Token data pipeline: the paper's synthetic datasets + a prefetching loader.

The port's own copy of ``repro/data/pipeline.py`` (numpy only, so its
batches are the JAX package's, value for value, for every kind and
seed); the port imports nothing of the JAX package.

Datasets (paper §5.1.2):
  * random   — seeded uniform random token sequences (identical across runs);
  * constant — a single token repeated (maximal router determinism);
  * zipf     — a heavy-tailed surrogate for the real-corpus token skews of
               BookCorpus/WikiText/WMT19 (which cannot ship in an offline
               container); the Zipf exponent is calibrated so the induced
               expert ECDF matches the paper's Figure 1 shape (~50% of mass
               on a handful of experts).

The loader prefetches batches on a host thread (straggler mitigation for the
input stage: device steps never wait on host tokenization).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class ByteTokenizer:
    """Deterministic byte-level tokenizer (for real-text examples)."""

    vocab_size = 256 + 2
    bos, eos = 256, 257

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        b = bytes(int(i) for i in ids if int(i) < 256)
        return b.decode("utf-8", errors="replace")


def synthetic_batches(kind: str, *, batch: int, seq_len: int, vocab: int,
                      seed: int = 0, zipf_a: float = 1.3
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens, labels} batches."""
    rng = np.random.default_rng(seed)
    while True:
        if kind == "random":
            toks = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int64)
        elif kind == "constant":
            toks = np.full((batch, seq_len + 1), 7, np.int64)
        elif kind == "zipf":
            toks = rng.zipf(zipf_a, (batch, seq_len + 1)) % vocab
        else:
            raise ValueError(kind)
        toks = toks.astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class PrefetchLoader:
    """Host-thread prefetch queue around any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            self._q.put(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
