"""Fault-tolerant checkpointing: the JAX package's layout, async save,
keep-k, CRC integrity and resume-from-latest (port of
``repro/checkpoint/checkpointer.py``).

Layout:  <dir>/step_<N>/
           manifest.json   {"step": N, "leaves": [{i, shape, dtype, crc32}]}
           leaf_<i>.npy    one array per leaf (the .npy format, version 1.0)
         <dir>/step_<N>.done   commit marker, written last

Leaves are numbered in ``jax.tree.flatten``'s order (``repro_torch.tree``:
sorted dict keys; an ``AdamWState`` as (step, m, v)), so a checkpoint of
``{"params": ..., "opt": ...}`` written by the JAX package restores here
(through the same tree the port builds) and the other way round.  A
bfloat16 leaf is written as its raw 16-bit words under the descriptor
``<V2``, which is what ``np.save`` writes for JAX's bfloat16 (no numpy
type of its own is needed), with ``"dtype": "bfloat16"`` in the
manifest; the CRC32 is over the leaf's raw bytes, as JAX's.  A directory
without its ``.done`` marker is torn and ignored by ``latest_step``.

Saving copies each device leaf through a pinned staging buffer a chunk
at a time and writes it with its CRC, the leaves spread over a few
threads.  ``save`` without ``blocking`` first takes a snapshot on the
host, as JAX's ``device_get`` does (a device leaf copied into pinned
memory, which PyTorch's caching host allocator keeps for the next
save), and writes it on a background thread; ``wait()`` joins it, and
the next ``save`` waits for the last one before it snapshots.
``restore`` checks every leaf's CRC and puts each leaf on the device of
the matching leaf of ``like``.  ``restore(..., shardings=)`` is the
elastic restore, JAX's ``shardings`` for a process of a grid
(``launch/grid.py``): a leaf with a ``RowShard`` loads only this
process's rows of the global leaf (read through a memory map), and a
checkpoint restores onto any grid whose global shapes agree; a leaf
whose shape cannot match raises, naming it.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T

_CHUNK = 1 << 26            # bytes a staged copy
_THREADS = 8
_NP = {torch.float32: np.float32, torch.float16: np.float16,
       torch.int32: np.int32, torch.int64: np.int64, torch.int8: np.int8,
       torch.uint8: np.uint8, torch.bool: np.bool_,
       torch.float64: np.float64}


class RowShard(NamedTuple):
    """Part ``index`` of ``parts`` equal slices of a leaf's ``axis``."""
    axis: int
    index: int
    parts: int


def _dtype_name(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(
        np.dtype(_NP[t.dtype]))


def _descr(t: torch.Tensor) -> str:
    return "<V2" if t.dtype == torch.bfloat16 else np.dtype(_NP[t.dtype]).str


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """A leaf's raw bytes, C order, as a flat uint8 tensor on its device."""
    t = t.detach().contiguous().reshape(-1)
    return t.view(torch.uint8) if t.numel() else t.new_empty(
        0, dtype=torch.uint8)


class _Stager:
    """One worker's pinned staging buffer and CUDA stream."""

    def __init__(self):
        self.buf = None
        self.stream = None

    def chunks(self, t: torch.Tensor, ready=None):
        """The raw bytes of ``t`` as numpy uint8 chunks (a device tensor
        through pinned memory, after ``ready``, the event its producer
        recorded)."""
        raw = _byte_view(t)
        if not raw.is_cuda:
            yield raw.numpy()
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(raw.device)
            self.buf = torch.empty(_CHUNK, dtype=torch.uint8,
                                   pin_memory=True)
        with torch.cuda.stream(self.stream):
            if ready is not None:
                self.stream.wait_event(ready)
            for lo in range(0, raw.numel(), _CHUNK):
                n = min(_CHUNK, raw.numel() - lo)
                self.buf[:n].copy_(raw[lo:lo + n], non_blocking=True)
                self.stream.synchronize()
                yield self.buf[:n].numpy()


def _header(t: torch.Tensor, shape) -> bytes:
    """The .npy (1.0) header of a leaf of ``t``'s dtype and ``shape``."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": _descr(t), "fortran_order": False,
              "shape": tuple(shape)})
    return buf.getvalue()


def _pwrite_all(fd: int, buf: np.ndarray, offset: int) -> None:
    """``buf``'s bytes at ``offset`` of ``fd``, in as many writes as the
    kernel takes (one write moves at most ~2 GiB)."""
    view = memoryview(buf).cast("B")
    done = 0
    while done < len(view):
        done += os.pwrite(fd, view[done:done + (1 << 30)], offset + done)


def _write_leaf(path: str, t: torch.Tensor, stager: _Stager, ready) -> dict:
    """``leaf_i.npy`` of ``t``; returns its manifest entry (less ``i``)."""
    crc = 0
    with open(path, "wb") as f:
        f.write(_header(t, t.shape))
        for chunk in stager.chunks(t, ready):
            f.write(memoryview(chunk))
            crc = zlib.crc32(memoryview(chunk), crc)
    return {"shape": list(t.shape), "dtype": _dtype_name(t), "crc32": crc}


def _snapshot_host(leaves: List[torch.Tensor], ready) -> List[torch.Tensor]:
    """Host copies of ``leaves``: a device leaf into pinned memory on a
    side stream after ``ready``, a host leaf cloned."""
    out, stream = [], None
    for t in leaves:
        if not t.is_cuda:
            out.append(t.detach().clone())
            continue
        if stream is None:
            stream = torch.cuda.Stream(t.device)
            stream.wait_event(ready)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(t.detach(), non_blocking=True)
        out.append(host)
    if stream is not None:
        stream.synchronize()
    return out


class Checkpointer:
    """``keep`` newest committed checkpoints are kept (0: all)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stagers = [_Stager() for _ in range(_THREADS)]

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Write ``tree`` as ``step_<step>``: at once with ``blocking``,
        else from a snapshot on a background thread."""
        self.wait()
        leaves = T.leaves(tree)
        ready = self._ready(leaves)
        if blocking:
            self._write(step, leaves, ready)
            return
        snap = _snapshot_host(leaves, ready)

        def run():
            try:
                self._write(step, snap, None)
            except BaseException as e:         # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    @staticmethod
    def _ready(leaves: List[torch.Tensor]):
        """An event after the work that made the device leaves."""
        dev = next((t.device for t in leaves if t.is_cuda), None)
        if dev is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def _write(self, step: int, leaves: List[torch.Tensor], ready) -> None:
        tmp = os.path.join(self.dir, f"_tmp_step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        # largest first, round-robin over the workers' stagers
        order = sorted(range(len(leaves)), key=lambda i: -leaves[i].numel()
                       * leaves[i].element_size())
        lanes = [order[w::_THREADS] for w in range(_THREADS)]
        entries: List[Optional[dict]] = [None] * len(leaves)

        def lane(w: int):
            for i in lanes[w]:
                e = _write_leaf(os.path.join(tmp, f"leaf_{i}.npy"),
                                leaves[i], self._stagers[w], ready)
                entries[i] = {"i": i, **e}
        with ThreadPoolExecutor(_THREADS) as ex:
            for fut in [ex.submit(lane, w) for w in range(_THREADS)]:
                fut.result()
        self._commit(step, tmp, entries)

    def _commit(self, step: int, tmp: str, entries: List[dict]) -> None:
        """The manifest, the rename to ``step_<step>`` and the marker."""
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": entries}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        # commit marker LAST: torn writes are never visible
        with open(final + ".done", "w") as f:
            f.write("ok")
        self._gc()

    def save_part(self, step: int, tree: Any,
                  shardings: Sequence[Optional[RowShard]], *, part: int,
                  parts: int, sync: Callable[[], None],
                  blocking: bool = False) -> None:
        """Part ``part`` of ``parts`` processes writes one checkpoint of the
        global leaves together with the others, each writing its own
        slice of every ``RowShard`` leaf into the one file (``tree``
        holds this process's slices), part 0 the other leaves: the files
        are those a one-process save of the global tree writes, byte for
        byte.  Part 0 makes the files (header, full size), ``sync()``
        (a barrier over the parts) lets every part write, each marks its
        part done, and part 0 then reads the files back for their CRCs
        and commits.  ``blocking`` as in ``save`` (without it each part
        writes from a host snapshot of what it writes, on a background
        thread)."""
        self.wait()
        leaves = T.leaves(tree)
        if len(shardings) != len(leaves):
            raise ValueError(f"{len(shardings)} shardings for "
                             f"{len(leaves)} leaves")
        tmp = os.path.join(self.dir, f"_tmp_step_{step}")
        shapes = []
        for t, shd in zip(leaves, shardings):
            shape = list(t.shape)
            if shd is not None:
                shape[shd.axis] *= parts
            shapes.append(shape)
        heads = [_header(t, shape) for t, shape in zip(leaves, shapes)]
        if part == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, (t, shape, head) in enumerate(zip(leaves, shapes, heads)):
                with open(os.path.join(tmp, f"leaf_{i}.npy"), "wb") as f:
                    f.write(head)
                    f.truncate(len(head) + t.element_size()
                               * int(np.prod(shape, dtype=np.int64)))
        sync()
        mine = [i for i, shd in enumerate(shardings)
                if shd is not None or part == 0]
        ready = self._ready(leaves)
        if blocking:
            src = {i: leaves[i] for i in mine}
        else:
            src = dict(zip(mine, _snapshot_host([leaves[i] for i in mine],
                                                ready)))
            ready = None

        def run():
            def one(i: int):
                t = src[i].detach()
                raw = (t.cpu() if t.is_cuda else t).contiguous().reshape(
                    -1).view(torch.uint8).numpy() if t.numel() else \
                    np.zeros(0, np.uint8)
                shd = shardings[i]
                fd = os.open(os.path.join(tmp, f"leaf_{i}.npy"), os.O_WRONLY)
                try:
                    if shd is None:
                        _pwrite_all(fd, raw, len(heads[i]))
                        return
                    # [outer, rows a part x inner] blocks of this part
                    outer = int(np.prod(t.shape[:shd.axis], dtype=np.int64))
                    block = raw.size // max(outer, 1)
                    for o in range(outer):
                        _pwrite_all(fd, raw[o * block:(o + 1) * block],
                                    len(heads[i])
                                    + (o * parts + shd.index) * block)
                finally:
                    os.close(fd)
            if ready is not None:
                ready.synchronize()
            with ThreadPoolExecutor(_THREADS) as ex:
                list(ex.map(one, mine))
            open(os.path.join(tmp, f"part_{part}.done"), "w").close()
            if part == 0:
                self._commit_parts(step, tmp, leaves, shapes, heads, parts)

        if blocking:
            run()
            return

        def background():
            try:
                run()
            except BaseException as e:         # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=background, daemon=True)
        self._thread.start()

    def _commit_parts(self, step, tmp, leaves, shapes, heads, parts,
                      timeout: float = 1800.0) -> None:
        """Part 0's commit of a ``save_part``: once every part's marker is
        there, each leaf's CRC read back from its file, the manifest, the
        rename and the commit marker."""
        import time
        t0 = time.monotonic()
        while not all(os.path.exists(os.path.join(tmp, f"part_{p}.done"))
                      for p in range(parts)):
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"checkpoint step {step}: a part did "
                                   f"not finish writing")
            time.sleep(0.01)

        def crc_of(i: int) -> dict:
            crc = 0
            with open(os.path.join(tmp, f"leaf_{i}.npy"), "rb") as f:
                f.seek(len(heads[i]))
                while True:
                    chunk = f.read(_CHUNK)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
            return {"i": i, "shape": shapes[i],
                    "dtype": _dtype_name(leaves[i]), "crc32": crc}
        with ThreadPoolExecutor(_THREADS) as ex:
            entries = list(ex.map(crc_of, range(len(leaves))))
        for p in range(parts):
            os.remove(os.path.join(tmp, f"part_{p}.done"))
        self._commit(step, tmp, entries)

    def wait(self) -> None:
        """Join the background save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = [int(n[len("step_"):-len(".done")])
                 for n in os.listdir(self.dir)
                 if n.startswith("step_") and n.endswith(".done")]
        return max(steps) if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, like: Any, *, verify: bool = True,
                only: Optional[str] = None, device=None,
                shardings: Optional[Sequence[Optional[RowShard]]] = None
                ) -> Any:
        """Load ``step`` into the structure of ``like``, each leaf on the
        device of ``like``'s leaf (on ``device`` when given), in the
        manifest's dtype.  ``only`` (a top-level key of ``like``) loads
        that subtree alone; the rest of ``like`` only fixes the leaf
        numbering (its leaves may be on the ``meta`` device) and comes
        back as it is.  ``shardings`` (one entry a leaf of ``like``, in
        ``tree.flatten``'s order) loads a ``RowShard`` leaf's own slice
        of the global leaf and a None one whole; each leaf's shape (its
        global shape for a slice) must be the checkpoint's, else a
        ValueError names the leaf."""
        final = os.path.join(self.dir, f"step_{step}")
        manifest = self.manifest(step)
        ref, structure = T.flatten(like)
        if len(ref) != len(manifest["leaves"]):
            raise ValueError("tree structure changed")
        shards = list(shardings) if shardings is not None \
            else [None] * len(ref)
        if len(shards) != len(ref):
            raise ValueError(f"{len(shards)} shardings for {len(ref)} "
                             f"leaves")
        names = T.paths(like)
        wanted = range(len(ref))
        if only is not None:         # sorted keys: the subtree's leaves
            start = sum(len(T.leaves(like[k])) for k in sorted(like)
                        if k < only)
            wanted = range(start, start + len(T.leaves(like[only])))
        for i in wanted:
            want, shd = list(ref[i].shape), shards[i]
            if shd is not None and shd.axis < len(want):
                want[shd.axis] *= shd.parts
            if manifest["leaves"][i]["shape"] != want:
                raise ValueError(
                    f"checkpoint leaf {i} ({names[i]}) has shape "
                    f"{manifest['leaves'][i]['shape']}; this process's "
                    f"leaf is {list(ref[i].shape)}"
                    + (f", {shd.parts} slices of axis {shd.axis}"
                       if shd is not None else "")
                    + f": {want}")
        out = list(ref)

        def load(i: int):
            meta = manifest["leaves"][i]
            arr = np.load(os.path.join(final, f"leaf_{meta['i']}.npy"),
                          mmap_mode="r")
            if verify:
                raw = arr.reshape(-1).view(np.uint8)
                crc = 0
                for lo in range(0, raw.size, _CHUNK):
                    crc = zlib.crc32(raw[lo:lo + _CHUNK], crc)
                if crc != meta["crc32"]:
                    raise IOError(f"checkpoint leaf {meta['i']} corrupt "
                                  f"(crc {crc} != {meta['crc32']})")
            shd = shards[i]
            if shd is not None:
                n = arr.shape[shd.axis] // shd.parts
                arr = arr[(slice(None),) * shd.axis
                          + (slice(shd.index * n, (shd.index + 1) * n),)]
            arr = np.array(arr)                 # out of the memory map
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out[i] = t.to(ref[i].device if device is None else device)
        with ThreadPoolExecutor(_THREADS) as ex:
            list(ex.map(load, wanted))
        return T.unflatten(structure, out)

    def restore_latest(self, like: Any, **kw):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, **kw)

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(n[len("step_"):-len(".done")])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and n.endswith(".done"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, f"step_{s}.done"))
            except OSError:
                pass
