"""Training entry point: resumable, fault-tolerant end-to-end loop (port of
``repro/launch/train.py``).

On the card (the default), full width, weights drawn from ``--seed``:
  PYTHONPATH=src python -m repro_torch.launch.train --arch switch128 \\
      --steps 20 --batch 4 --seq-len 512 --dataset zipf \\
      --ckpt-dir /tmp/ckpt --ckpt-every 10
On the CPU, at reduced size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --device cpu --steps 50 --batch 8 --seq-len 64 \\
      --ckpt-dir /tmp/ckpt --resume auto

Across processes, on the (data, model) grid of JAX's mesh, under a
launcher that sets ``RANK`` and ``WORLD_SIZE`` = data x model (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``):
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen15-moe-a27b --reduced \
      --device cpu --data-par 2 --model-par 2 --steps 20 --batch 8 \
      --seq-len 64 --ckpt-dir /tmp/ckpt

The flags are ``repro.launch.train``'s, plus ``--device`` (cuda unless
given).  In one process ``--model-par G`` builds the model at
expert-parallel degree G on virtual ranks of the one device
(``VirtualGroup``), as the serving CLI reads it, and ``--data-par`` > 1
raises (one process is one grid point: it needs a launcher).  Under a launcher each process is one
point of the grid (``launch/grid.py``): it holds its EP rank's expert
rows and a replica of the rest, takes its data shard of the global
batch, and averages the gradients over its data-parallel group before
AdamW; a checkpoint holds the global leaves and restores onto another
grid (the elastic restart; ``--data-par`` 0 takes ``WORLD_SIZE //
--model-par``, as JAX takes its devices).  Every
``--ckpt-every`` steps the parameters and the AdamW state are
checkpointed asynchronously (``checkpoint/checkpointer.py``), and the
run resumes from the latest committed checkpoint (``--resume auto``);
``REPRO_FAIL_AT_STEP=N`` kills the loop at step N for drills.  A resumed
run skips the batches the earlier run consumed, so that killed-and-
resumed and uninterrupted runs end bit-equal (the JAX trainer restarts
its data stream at a resume).  Log lines are the JAX trainer's, printed
by process 0:
``[train] step N loss ... tok/s ...``, ``[train] resumed from step N``
and ``[train] loss a -> b (improved|NOT improved)``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ParallelConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import PrefetchLoader, synthetic_batches
from repro_torch.launch.grid import init_grid
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault_tolerance import FailureInjector


@dataclass
class TrainResult:
    """What a ``train_loop`` run leaves: the final state, each step's
    loss and wall seconds (the step and its loss read back), the seconds
    its checkpoint saves held the loop, the step it started from, and
    the model."""
    params: Any
    opt: Any
    model: Any
    start: int
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    ckpt_seconds: float = 0.0


def train_loop(args, *, on_grads: Optional[Callable] = None,
               after_step: Optional[Callable] = None,
               on_restore: Optional[Callable] = None,
               moe_layer_diags: bool = False, grid=None,
               cfg=None) -> TrainResult:
    """Run ``args`` (``build_parser``'s namespace).  ``on_grads(grads,
    diags)`` sees each step's gradients before the update (with
    ``moe_layer_diags`` the diagnostics carry each MoE layer's expert
    loads); ``after_step(step, params, opt, loss, diags)`` runs after
    each step's update, before its checkpoint; ``on_restore(step,
    state)`` sees a resumed run's restored ``{"params", "opt"}`` (this
    process's leaves on a grid).  ``grid`` is this process's grid point
    (``launch/grid.py``), made from the launcher's environment when not
    given; ``cfg`` the model's config in place of ``--arch`` (a cut
    one)."""
    if grid is None:
        grid, device = init_grid(args.device, data=args.data_par,
                                 model=args.model_par)
    else:
        device = torch.device(args.device)
    if grid is None and args.data_par > 1:
        raise NotImplementedError(
            f"--data-par {args.data_par}: data parallelism runs one process "
            f"a grid point; start {args.data_par} x --model-par processes "
            f"under a launcher (torchrun)")
    say = grid is None or grid.rank == 0
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    pcfg = ParallelConfig(remat=args.remat, microbatch=args.microbatch,
                          attn_chunk=min(512, args.seq_len),
                          loss_chunk=min(2048, args.seq_len))
    model = build_model(cfg, pcfg, batch=(grid.local_batch(args.batch)
                                          if grid else args.batch),
                        seq_len=args.seq_len, device=device,
                        ep_degree=args.model_par,
                        comm=grid.comm() if grid else None)
    dev = model.device
    ckpt = Checkpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    injector = FailureInjector.from_env()

    params = model.init(args.seed)
    opt = adamw_init(params)
    start = 0
    if ckpt and args.resume == "auto":
        latest = ckpt.latest_step()
        if latest is not None:
            like = {"params": params, "opt": opt}
            state = ckpt.restore(latest, like, shardings=(
                grid.shardings(like) if grid else None))
            params, opt = state["params"], state["opt"]
            start = latest
            if say:
                print(f"[train] resumed from step {latest}")
            if on_restore is not None:
                on_restore(latest, state)

    def save(step: int, blocking: bool) -> None:
        state = {"params": params, "opt": opt}
        if grid is None:
            ckpt.save(step, state, blocking=blocking)
        else:
            grid.save(ckpt, step, state, blocking=blocking)

    step_fn = make_train_step(model, lr=args.lr, on_grads=on_grads,
                              moe_layer_diags=moe_layer_diags, grid=grid)
    batches = synthetic_batches(args.dataset, batch=args.batch,
                                seq_len=args.seq_len, vocab=cfg.vocab_size,
                                seed=args.seed)
    for _ in range(start):            # the batches the earlier run took
        next(batches)
    loader = PrefetchLoader(batches)

    res = TrainResult(params, opt, model, start)
    saved = None
    try:
        t0 = time.time()
        for step in range(start, args.steps):
            injector.check(step)
            batch = next(loader)
            if grid is not None:
                batch = grid.shard_batch(batch, args.microbatch)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            ts = time.perf_counter()
            params, opt, loss, diags = step_fn(params, opt, batch)
            res.losses.append(float(loss))
            res.step_seconds.append(time.perf_counter() - ts)
            if after_step is not None:
                after_step(step + 1, params, opt, loss, diags)
            if (step + 1) % args.log_every == 0 and say:
                tput = args.log_every * args.batch * args.seq_len \
                    / (time.time() - t0)
                extra = ""
                if "send_drops" in diags:
                    extra = (f" drops={float(diags['send_drops']):.0f}"
                             f" moved={float(diags['moved_units']):.0f}")
                print(f"[train] step {step + 1} loss {float(loss):.4f} "
                      f"tok/s {tput:.0f}{extra}")
                t0 = time.time()
            if ckpt and (step + 1) % args.ckpt_every == 0:
                # the last step's state is written at once (it is the
                # final checkpoint's: no snapshot needed)
                tc = time.perf_counter()
                save(step + 1, blocking=step + 1 == args.steps)
                res.ckpt_seconds += time.perf_counter() - tc
                saved = step + 1
        if ckpt and saved != args.steps:
            tc = time.perf_counter()
            save(args.steps, blocking=True)
            res.ckpt_seconds += time.perf_counter() - tc
    finally:
        loader.close()
        if ckpt:                    # a pending save commits, even on failure
            ckpt.wait()
    if len(res.losses) >= 10 and say:
        a, b = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
        print(f"[train] loss {a:.4f} -> {b:.4f} "
              f"({'improved' if b < a else 'NOT improved'})")
    res.params, res.opt = params, opt
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="random",
                    choices=["random", "constant", "zipf"])
    ap.add_argument("--remat", default="none", choices=["none", "full"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--data-par", type=int, default=0)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", default="auto", choices=["auto", "never"])
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    train_loop(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
