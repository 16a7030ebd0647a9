"""The port's schedule time model (``repro_torch.core.simulator``) against
the JAX package's (``repro.core.simulator``): at the same cost values
(the port's H100 defaults handed to both, NVLink in the reference's ICI
slot), every metric of ``simulate_layer`` is equal, over the port
scheduler's schedules at G = 1, 4 and 8 under skewed counts, with and
without the replica mask (``extra_local``), the residency demotions
(``non_local``) and the staged misses (``hidden_stages``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.qthreshold import HardwareSpec as JHardware
from repro.core.simulator import SimCosts as JCosts
from repro.core.simulator import simulate_layer as jax_simulate
from repro.core.topology import make_topology as jax_topology
from repro_torch.core.scheduler import schedule
from repro_torch.core.simulator import SimCosts, simulate_layer
from repro_torch.core.topology import make_topology

E = 16


def _jax_costs(costs: SimCosts) -> JCosts:
    hw = costs.hw
    jhw = JHardware(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                    ici_bw=hw.link_bw, dtype_bytes=hw.dtype_bytes)
    kw = {f.name: getattr(costs, f.name)
          for f in dataclasses.fields(costs) if f.name != "hw"}
    return JCosts(hw=jhw, **kw)


def _cases():
    for G in (1, 4, 8):
        for masks in ("none", "extra_local", "non_local", "hidden_stages"):
            yield G, masks


@pytest.mark.parametrize("G,masks", list(_cases()))
def test_simulate_layer_equals_jax(G, masks):
    rng = np.random.default_rng(G * 10 + len(masks))
    topo, jtopo = make_topology(G, E), jax_topology(G, E)
    Ep = topo.padded_experts
    # skewed counts: two hot experts take most of each rank's units
    p = np.full(Ep, 1.0)
    p[:2] = 12.0
    counts = np.stack([rng.multinomial(256, p / p.sum())
                       for _ in range(G)]).astype(np.int32)
    extra = non_local = hidden = None
    if masks == "extra_local":
        extra = np.zeros((G, Ep), bool)
        extra[np.arange(G), rng.integers(0, Ep, G)] = True
    if masks in ("non_local", "hidden_stages"):
        non_local = rng.random((G, Ep)) < 0.3
        if masks == "hidden_stages":
            hidden = rng.random((G, Ep)) < 0.5
    S, diag = schedule(
        torch.from_numpy(counts), topo, policy="harmoeny", q=4, c_pair=64,
        num_foreign_slots=4,
        extra_local=None if extra is None else torch.from_numpy(extra),
        non_local=None if non_local is None else torch.from_numpy(non_local))
    S = S.numpy()
    costs = SimCosts(d_model=4096, d_ff=14336, n_matrices=3)
    kw = dict(sched_iters=int(diag.iters) + 3, drops=2, extra_local=extra,
              non_local=non_local, hidden_stages=hidden)
    got = simulate_layer(S, topo, costs, **kw)
    want = jax_simulate(S, jtopo, _jax_costs(costs), **kw)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                   err_msg=key)
    assert got["layer_s"] > 0
    if masks == "non_local":
        assert got["host_stall_s"] > 0 or not non_local.any()


def test_defaults_are_the_cards():
    """The defaults are the H100's and this card's measured costs, not the
    reference's v5e constants."""
    c = SimCosts()
    assert c.hw.peak_flops == 989e12 and c.hw.link_bw == 450e9
    assert (c.host_bw, c.launch_us, c.mfu, c.sched_iter_us) \
        == (48e9, 6.2, 0.547, 0.0)
    j = JCosts()
    assert j.hw.peak_flops != c.hw.peak_flops and j.host_bw != c.host_bw
