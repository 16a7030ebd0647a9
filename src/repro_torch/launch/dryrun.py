"""Dry-run: build, shard and count every (arch x shape x mesh) cell on the
``meta`` device (port of ``repro/launch/dryrun.py``).

JAX's dry-run lowers and compiles each cell for a 16 x 16 (or 2 x 16 x 16)
mesh of fake CPU devices from ``ShapeDtypeStruct`` stand-ins, allocating
nothing, and reads XLA's memory and cost analyses.  The port does the
same from the ``meta`` device: the full-width model is built there at the
mesh's ``model`` axis as its expert-parallel degree (``VirtualGroup(ep,
"meta")``; mixtral's 8 experts on 16 ranks go tensor-parallel), its
parameters are ``Model.param_shapes()``, the shardings of
``launch/shardings`` size each device's share of the arguments, and the
step runs once on meta under ``launch/op_analysis.analyze``, which counts
its operations, bytes and collectives.  The meta device computes nothing,
so it is not a fallback from the card: it plays the part of JAX's
CPU-only lowering, and no other entry point changes its default device.
The step takes the plain branches (``kernels=False``), as JAX's dry-run
lowers with ``use_pallas=False``; the kernels refuse meta tensors.

What a cell reports (``results/dryrun_torch/<arch>__<shape>__<mesh>.json``,
JAX's keys):
  * ``memory.argument_bytes``: per device, summed over shard shapes: the
    parameters, AdamW's ``m`` and ``v`` and its step for a train cell,
    the caches and the position for a decode cell, and the batch.
    ``temp_bytes`` and ``peak_bytes`` are null: meta has no allocator.
    ``output_bytes`` is the step's outputs over ``n_chips``.
  * ``flops``, ``bytes_accessed`` and ``collectives``: the whole step's
    counts divided by ``n_chips`` (``"per_device": "even split"``).  The
    port has no SPMD partitioner, so this is not a partitioned program's
    count; ``flops_raw`` and ``bytes_raw`` are the whole step's.  The
    collectives are the expert-parallel ones the port issues; the data,
    FSDP and attention-TP collectives that GSPMD inserts in JAX have no
    counterpart, since the port runs none of them.  ``collectives.counts``
    are the group collectives each rank takes part in (not divided).
  * ``model_flops`` (analytic, the whole step), ``param_count``, ``fits``
    (argument bytes against the card's memory: the current card's when
    one is present, else the H100 data sheet's 80 GB), ``wall_s``.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--force]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.configs import (SHAPE_BY_NAME, SHAPES, get_config,
                                 iter_cells)
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.launch import op_analysis
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, optimizer_shapes)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
H100_BYTES = 80e9      # the H100 SXM data sheet's 80 GB of HBM3


def parallel_config(cfg: ModelConfig, shape: ShapeConfig) -> ParallelConfig:
    """JAX's: FSDP, full remat and 4 microbatches for training, the KV
    sequence over 'data' at long_500k, 512-row MoE tiles except at decode.
    JAX's ``use_pallas=False`` is the steps' ``kernels=False`` here."""
    return ParallelConfig(
        fsdp=(shape.kind == "train"),
        remat="full" if shape.kind == "train" else "none",
        shard_kv_seq=(shape.name == "long_500k"),
        microbatch=4 if shape.kind == "train" else 0,
        moe_block_m=512 if shape.kind != "decode" else 128,
    )


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sharded_bytes(leaves_and_specs, sizes) -> int:
    return sum(math.prod(SH.shard_shape(t.shape, spec, sizes))
               * t.element_size() for t, spec in leaves_and_specs)


def _pairs(t: Any, specs: Any):
    """(leaf, spec) pairs of a tree and the tree of its specs."""
    return list(zip(tree.leaves(t), tree.leaves(specs)))


def make_inputs(model, shape: ShapeConfig, device, seed: int = 0
                ) -> Dict[str, torch.Tensor]:
    """The step's batch at ``shape``: ``tokens`` (and ``labels`` for
    training) [B, S] int32, or [B, 1] at decode; whisper's ``frames``,
    pixtral's ``patches``.  Empty on ``meta``; elsewhere drawn from
    ``seed`` on the CPU and moved."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    dev = torch.device(device)
    meta = dev.type == "meta"
    gen = None if meta else torch.Generator().manual_seed(seed)

    def ints(shp):
        if meta:
            return torch.empty(shp, dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab_size, shp, generator=gen,
                             dtype=torch.int32).to(dev)

    def floats(shp):
        if meta:
            return torch.empty(shp, dtype=model.dtype, device=dev)
        return torch.randn(shp, generator=gen).to(model.dtype).to(dev)
    batch = {"tokens": ints((B, 1) if shape.kind == "decode" else (B, S))}
    if shape.kind == "train":
        batch["labels"] = ints((B, S))
    if cfg.is_encoder_decoder:
        batch["frames"] = floats((B, cfg.encoder_seq_len, cfg.d_model))
    if cfg.num_prefix_embeddings:
        batch["patches"] = floats((B, cfg.num_prefix_embeddings,
                                   cfg.d_model))
    return batch


def make_cell_step(model, shape: ShapeConfig, *, kernels: bool = False):
    """The step a cell of ``shape``'s kind runs: ``make_train_step``,
    ``make_prefill_step`` at ``s_max = seq + 64`` or ``make_decode_step``.
    ``kernels`` False takes the plain branches, as the dry-run counts; a
    train step always does (no kernel has a backward)."""
    if shape.kind == "train":
        return make_train_step(model)
    if shape.kind == "prefill":
        return make_prefill_step(model, s_max=shape.seq_len + 64,
                                 kernels=kernels)
    return make_decode_step(model, kernels=kernels)


def cell_step(model, shape: ShapeConfig, params, batch):
    """(the plain step of ``make_cell_step``, its arguments, what the step
    reads besides ``params`` and ``batch``): fresh AdamW state for a
    train cell, ``init_cache(batch, seq)`` at position ``seq - 1`` for a
    decode cell.  The state is made on the parameters' device."""
    dev = tree.leaves(params)[0].device
    step = make_cell_step(model, shape)
    if shape.kind == "train":
        opt = (optimizer_shapes(params) if dev.type == "meta"
               else adamw_init(params))
        return step, (params, opt, batch), {"opt": opt}
    if shape.kind == "prefill":
        return step, (params, batch), {}
    caches = model.init_cache(shape.global_batch, shape.seq_len, device=dev)
    pos = (torch.empty((), dtype=torch.int32, device=dev)
           if dev.type == "meta" else
           torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=dev))
    return step, (params, batch["tokens"], caches, pos), \
        {"caches": caches, "pos": pos}


def argument_bytes(cfg: ModelConfig, pcfg: ParallelConfig,
                   shape: ShapeConfig, mesh: Mesh, params, batch,
                   state: Dict[str, Any]) -> int:
    """Per-device bytes of the step's arguments, summed over shard shapes
    (``launch/shardings``): parameters, then AdamW's moments (the
    parameters' specs) and step, or the caches and the position, and the
    batch."""
    sizes = mesh.sizes
    total = _sharded_bytes(
        _pairs(params, SH.param_shardings(params, cfg, pcfg, mesh)), sizes)
    if "opt" in state:
        opt = state["opt"]
        total += _nbytes(opt.step)
        for moments in (opt.m, opt.v):
            total += _sharded_bytes(
                _pairs(moments, SH.param_shardings(moments, cfg, pcfg,
                                                   mesh)), sizes)
    if "caches" in state:
        c = state["caches"]
        total += _sharded_bytes(_pairs(c, SH.cache_shardings(
            c, cfg, global_batch=shape.global_batch, mesh=mesh,
            shard_kv_seq=pcfg.shard_kv_seq)), sizes)
        total += _nbytes(state["pos"])
    total += _sharded_bytes(_pairs(batch, SH.batch_shardings(
        batch, global_batch=shape.global_batch, mesh=mesh)), sizes)
    return int(total)


def card_bytes() -> Tuple[float, str]:
    """The memory ``fits`` compares with, and where it comes from."""
    if torch.cuda.is_available():
        return (float(torch.cuda.get_device_properties(0).total_memory),
                torch.cuda.get_device_name(0))
    return H100_BYTES, "H100 data sheet (80 GB)"


def lower_cell(arch: str, shape: Union[str, ShapeConfig], *,
               multi_pod: bool = False, mesh: Optional[Mesh] = None,
               verbose: bool = True) -> Dict[str, Any]:
    """One cell on the ``meta`` device (the name is JAX's, which lowers
    and compiles; this builds and counts, module docstring).  ``shape``
    is a name of ``SHAPES`` or a ``ShapeConfig`` of its own (a cell cut
    in batch); ``mesh`` overrides the production mesh (the card's
    ``make_host_mesh(1, 1)``)."""
    t_start = time.time()
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape] if isinstance(shape, str) else shape
    pcfg = parallel_config(cfg, shape)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    model = build_model(cfg, pcfg, batch=shape.global_batch,
                        seq_len=shape.seq_len, device="meta",
                        ep_degree=mesh.sizes.get("model", 1))
    params = model.param_shapes()
    batch = make_inputs(model, shape, "meta")
    step, args, state = cell_step(model, shape, params, batch)
    arg_bytes = argument_bytes(cfg, pcfg, shape, mesh, params, batch, state)
    t_lower = time.time() - t_start

    t0 = time.time()
    with op_analysis.OpCounter() as counter:
        out = step(*args)
    t_run = time.time() - t0
    stats = counter.result()
    out_bytes = sum(_nbytes(t) for t in tree.leaves(out)
                    if isinstance(t, torch.Tensor))
    capacity, capacity_of = card_bytes()

    def split(x):
        return x / n_chips
    result = {
        "arch": arch, "shape": shape.name, "multi_pod": multi_pod,
        "mesh": dict(mesh.sizes), "n_chips": n_chips,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "device": "meta", "per_device": "even split",
        "lower_s": round(t_lower, 2), "compile_s": None,
        "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": int(split(out_bytes)),
            "temp_bytes": None,
            "peak_bytes": None,
        },
        "flops_raw": stats["flops"],
        "bytes_raw": stats["bytes_accessed"],
        "flops": split(stats["flops"]),
        "bytes_accessed": split(stats["bytes_accessed"]),
        "bytes_all": split(stats["bytes_all"]),
        "collectives": {
            "total": split(stats["collective_bytes"]),
            "per_kind": {k: split(v) for k, v in
                         stats["collectives_per_kind"].items()},
            "counts": stats["collective_counts"],
        },
        "model_flops": model_flops_estimate(cfg, shape),
        "param_count": param_count(params),
        "hlo_ops": stats["ops"],
        "fits": arg_bytes <= capacity,
        "fits_capacity_bytes": capacity,
        "fits_capacity_of": capacity_of,
    }
    result["wall_s"] = round(time.time() - t_start, 2)
    if verbose:
        tag = "multi" if multi_pod else "single"
        print(f"[{arch} x {shape.name} x {tag} ({n_chips} chips, "
              f"mesh {dict(mesh.sizes)})]")
        print(f"  build {t_lower:.1f}s run on meta {t_run:.1f}s, "
              f"{stats['ops']} aten ops")
        print(f"  per device: argument {arg_bytes / 1e9:.3f} GB "
              f"(fits {capacity / 1e9:.1f} GB: {result['fits']}), "
              f"flops={result['flops']:.3e} "
              f"bytes={result['bytes_accessed']:.3e} "
              f"coll={result['collectives']['total']:.3e}B")
        print(f"  whole step: flops={stats['flops']:.3e} "
              f"model_flops={result['model_flops']:.3e} "
              f"params={result['param_count']}")
    return result


def param_count(param_shapes: Any) -> int:
    return int(sum(t.numel() for t in tree.leaves(param_shapes)))


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS (whole step, all chips): 6*N*D train (dense),
    6*N_active*D (MoE); 2*N(_active)*D for forward-only steps."""
    n_total, n_active = _active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


def _active_params(cfg: ModelConfig):
    """(total, activated-per-token) parameter counts from the config."""
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.resolved_head_dim
    attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    n_mats = 3 if cfg.act in ("swiglu", "gelu") else 2
    dense_ffn = n_mats * d * cfg.d_ff
    embed = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    ssm = 0
    if cfg.ssm is not None:
        from repro_torch.models.mamba2 import mamba_dims
        dm = mamba_dims(cfg)
        ssm = 2 * d * dm.d_inner + dm.d_inner * d \
            + 2 * d * dm.state + d * dm.n_heads
    if cfg.family == "ssm":
        total = L * ssm + embed
        return total, total
    if cfg.family == "hybrid":
        shared = attn + dense_ffn
        total = L * ssm + shared + embed
        active = total  # shared block applied every group
        return total, active
    if cfg.is_moe:
        m = cfg.moe
        n_moe = (L - m.first_dense_layers) // m.moe_layer_period
        n_dense_layers = L - n_moe
        expert = n_mats * d * m.d_ff_expert
        shared_e = m.num_shared_experts * expert
        router = d * m.num_experts
        total = (L * attn + n_dense_layers * dense_ffn
                 + n_moe * (m.num_experts * expert + shared_e + router) + embed)
        active = (L * attn + n_dense_layers * dense_ffn
                  + n_moe * (m.num_experts_per_tok * expert + shared_e + router)
                  + embed)
        return total, active
    enc = cfg.encoder_layers * (attn + dense_ffn) if cfg.is_encoder_decoder else 0
    cross = L * 4 * d * cfg.num_heads * hd if cfg.is_encoder_decoder else 0
    total = L * (attn + dense_ffn) + enc + cross + embed
    return total, total


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = "multi" if multi_pod else "single"
    return os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{tag}.json")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             force: bool = False) -> Dict[str, Any]:
    path = cell_path(arch, shape_name, multi_pod)
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    try:
        result = lower_cell(arch, shape_name, multi_pod=multi_pod)
    except Exception as e:  # record failures for triage, then re-raise
        result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()}
        with open(path + ".failed", "w") as f:
            json.dump(result, f, indent=2)
        raise
    if os.path.exists(path + ".failed"):
        os.remove(path + ".failed")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if args.all:
        ok, failed = 0, []
        t0 = time.time()
        for mp in meshes:
            for arch, shape, runnable, why in iter_cells(include_skipped=True):
                if not runnable:
                    print(f"[skip] {arch} x {shape.name}: {why}")
                    continue
                try:
                    run_cell(arch, shape.name, multi_pod=mp, force=args.force)
                    ok += 1
                except Exception as e:
                    print(f"[FAIL] {arch} x {shape.name} x "
                          f"{'multi' if mp else 'single'}: {e}")
                    failed.append((arch, shape.name, mp))
        print(f"\ndry-run matrix: {ok} cells ok, {len(failed)} failed "
              f"({time.time() - t0:.1f} s)")
        for f in failed:
            print("  FAILED:", f)
        raise SystemExit(1 if failed else 0)

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    for mp in meshes:
        run_cell(args.arch, args.shape, multi_pod=mp, force=args.force)


if __name__ == "__main__":
    main()
