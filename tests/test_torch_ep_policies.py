"""The port's engine at EP degree 4 on its own: scheduling moves compute,
never the math.  Under the paper's synthetic skew the greedy streams are
identical across harmoeny, round_robin and even_split when nothing is
dropped, and HarMoEny's decode max/mean rank load is below
round-robin's; with learned routing the G = 4 engine's streams equal the
G = 1 engine's on the same weights.  Plus the ``cuda``-marked G = 4 check
of the card against the CPU."""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.qwen15_moe_a27b import CONFIG as TORCH_QWEN
from repro_torch.core.topology import make_topology
from repro_torch.models.model import build_model
from repro_torch.serve import (Request, ServeEngine, VirtualClock,
                               engine_config_for)

from _ep_helpers import one_torch_thread  # noqa: F401 (autouse)
from _serve_helpers import captured_run

G, SLOTS, L, GEN, C = 4, 4, 12, 6, 4
KW = dict(max_slots=SLOTS, prompt_len=L, max_new_tokens=GEN, prefill_chunk=C,
          kv_block_size=4)


def _cfg(**moe):
    cfg = TORCH_QWEN.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, q_tokens=1, **moe))


def _trace():
    rng = np.random.default_rng(11)
    return [Request(rid=i, tokens=rng.integers(
                1, 500, (int(rng.integers(3, L + 1)),)).astype(np.int32),
                max_new_tokens=GEN, arrival_time=0.0) for i in range(6)]


def _serve(cfg, params, *, ep_degree, policy=None, device="cpu"):
    model = build_model(cfg, batch=SLOTS, seq_len=L, device=device,
                        ep_degree=ep_degree)
    eng = ServeEngine(model, params, engine_config_for(
        cfg, paged=True, moe_policy=policy, skew_seed=2, **KW),
        clock=VirtualClock(0.1), device=device)
    return captured_run(eng, _trace())


def _to_rank_major(params1, cfg, G_):
    """G = 1 expert rows (row e = expert e) in the rank-major order of G_
    ranks (row g * epr + j = the expert in slot j of rank g)."""
    order = torch.as_tensor(
        make_topology(G_, cfg.moe.num_experts).slot_map.reshape(-1)).long()
    out = dict(params1)
    blocks = {}
    for sub, p in params1["stack"]["blocks"].items():
        moe = dict(p["moe"])
        for name in ("w_in", "w_out", "w_gate"):
            moe[name] = moe[name][:, order]         # [layers, rows, ...]
        blocks[sub] = dict(p, moe=moe)
    out["stack"] = dict(params1["stack"], blocks=blocks)
    return out


def test_policies_token_identical_under_skew():
    cfg = _cfg(router_skew=0.9)
    params = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                         ep_degree=G).init(0)
    streams, lb = {}, {}
    for policy in ("harmoeny", "round_robin", "even_split"):
        out, rep = _serve(cfg, params, ep_degree=G, policy=policy)
        assert rep["n_requests"] == 6
        dec = rep["load_balance"]["decode"]
        assert dec["send_drops_total"] == dec["dest_drops_total"] == 0, policy
        assert rep["engine"]["moe_policy"] == policy
        streams[policy], lb[policy] = out, dec
    assert streams["round_robin"] == streams["harmoeny"]
    assert streams["even_split"] == streams["harmoeny"]
    # the hot expert's rank carries most of round-robin's decode load
    assert lb["round_robin"]["max_mean_ratio"] > 2.0
    assert lb["harmoeny"]["max_mean_ratio"] < lb["round_robin"]["max_mean_ratio"]
    assert lb["harmoeny"]["straggler_wait_units"] \
        < lb["round_robin"]["straggler_wait_units"]


def test_g4_streams_equal_g1_streams():
    cfg = _cfg()
    params1 = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu").init(0)
    out1, rep1 = _serve(cfg, params1, ep_degree=1)
    out4, rep4 = _serve(cfg, _to_rank_major(params1, cfg, G), ep_degree=G)
    assert rep1["n_requests"] == rep4["n_requests"] == 6
    assert out4 == out1
    assert len(rep4["load_balance"]["decode"]["rank_load_mean"]) == G
    assert len(rep1["load_balance"]["decode"]["rank_load_mean"]) == 1
    assert rep4["moe"]["decode/moved_units"] > 0       # G = 4 really moved


@pytest.mark.cuda
def test_g4_engine_on_card_equals_cpu():
    """Reduced qwen in f32 with learned routing at G = 4: the card's
    greedy streams (moe_gmm with foreign groups, paged attention) equal the
    CPU's through the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    if shutil.which("nvcc") is None and not \
            os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    cfg = _cfg()
    params = build_model(cfg, batch=SLOTS, seq_len=L, device="cpu",
                         ep_degree=G).init(0)
    out_cpu, _ = _serve(cfg, params, ep_degree=G)
    on_card = _tree_to(params, "cuda")
    out_card, rep = _serve(cfg, on_card, ep_degree=G, device="cuda")
    assert out_card == out_cpu
    assert rep["moe"]["decode/moved_units"] > 0


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)
