"""Mamba2 block: SSD (state-space duality, arXiv:2405.21060).

Port of ``repro/models/mamba2.py``.  Prefill: the chunked SSD algorithm,
a loop over sequence chunks; within a chunk the quadratic
(attention-like) form, across chunks the recurrent state [B, H, P, N]
carried in f32.  Decode (L = 1 with a state): the O(1) recurrence
h <- dA * h + dt * x (x) B, y = h . C.

The JAX package writes the SSD scan in ``jnp``, not Pallas, so plain
PyTorch ops are its port: no kernel runs here on the card either.
Projections are per component (z, x, B, C, dt) with per-component causal
convs, and B and C are shared across heads (ngroups = 1), as in the
reference.  ``mamba_block`` returns the new state (fresh tensors); the
stack copies it into the cache in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm


class MambaDims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    state: int
    conv_w: int


def mamba_dims(cfg: ModelConfig) -> MambaDims:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.num_heads or (d_inner // s.head_dim)
    return MambaDims(d_inner, n_heads, s.head_dim, s.state_dim, s.conv_width)


class MambaState(NamedTuple):
    ssm: torch.Tensor      # [B, H, P, N] float32
    conv_x: torch.Tensor   # [B, W-1, d_inner]
    conv_B: torch.Tensor   # [B, W-1, N]
    conv_C: torch.Tensor   # [B, W-1, N]


def init_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
               device=None, lead: Tuple[int, ...] = ()) -> MambaState:
    """Zero state of ``batch`` sequences; ``lead`` prepends stacking axes
    (layers, groups) to every leaf."""
    dm = mamba_dims(cfg)

    def z(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=device)
    return MambaState(
        ssm=z((batch, dm.n_heads, dm.head_dim, dm.state), torch.float32),
        conv_x=z((batch, dm.conv_w - 1, dm.d_inner), dtype),
        conv_B=z((batch, dm.conv_w - 1, dm.state), dtype),
        conv_C=z((batch, dm.conv_w - 1, dm.state), dtype))


def init_mamba(cfg: ModelConfig, nrm, full, lead: Tuple[int, ...] = ()
               ) -> Dict[str, torch.Tensor]:
    """One block's parameters at the JAX init's scales, with ``lead``
    stacking axes: ``nrm(shape, scale)`` draws normals in the model dtype,
    ``full(shape, value, dtype)`` fills (a value broadcast over ``shape``;
    dtype None: the model's)."""
    dm = mamba_dims(cfg)
    d = cfg.d_model
    s_in = (2.0 / d) ** 0.5
    n, f32 = lead, torch.float32
    return {
        "wz": nrm(n + (d, dm.d_inner), s_in),
        "wx": nrm(n + (d, dm.d_inner), s_in),
        "wB": nrm(n + (d, dm.state), s_in),
        "wC": nrm(n + (d, dm.state), s_in),
        "wdt": nrm(n + (d, dm.n_heads), s_in),
        "out_proj": nrm(n + (dm.d_inner, d), (2.0 / dm.d_inner) ** 0.5),
        "conv_x": nrm(n + (dm.conv_w, dm.d_inner), 0.2),
        "conv_B": nrm(n + (dm.conv_w, dm.state), 0.2),
        "conv_C": nrm(n + (dm.conv_w, dm.state), 0.2),
        "conv_bx": full(n + (dm.d_inner,), 0.0, None),
        "conv_bB": full(n + (dm.state,), 0.0, None),
        "conv_bC": full(n + (dm.state,), 0.0, None),
        "A_log": full(n + (dm.n_heads,), torch.log(
            torch.arange(1, dm.n_heads + 1, dtype=f32)), f32),
        "D": full(n + (dm.n_heads,), 1.0, f32),
        "dt_bias": full(n + (dm.n_heads,), -2.0, f32),
        "norm_scale": full(n + (dm.d_inner,), 0.0, f32),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 valid_len: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv + silu.  x: [B, L, C]; w: [W, C]; state: the
    last W-1 inputs.  With ``valid_len`` ([B] or a scalar, a device tensor
    in a captured step) only the first ``valid_len`` positions are real
    tokens, and the carried state holds the last W-1 valid inputs."""
    W = w.shape[0]
    Bb, L, C = x.shape
    if state is None:
        state = x.new_zeros((Bb, W - 1, C))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + L, :] * w[i][None, None, :] for i in range(W))
    if W > 1:
        if valid_len is None:
            new_state = xp[:, -(W - 1):, :]
        else:
            # valid tokens sit at xp[:, W-1 : W-1+vl]; the last W-1 valid
            # inputs (state included, for vl < W-1) are xp[:, vl : vl+W-1]
            vl = torch.as_tensor(valid_len, device=x.device).long() \
                .reshape(-1).expand(Bb)
            idx = vl[:, None] + torch.arange(W - 1, device=x.device)[None]
            new_state = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, C))
    else:
        new_state = state
    return F.silu(y + b[None, None, :]), new_state


def _chunk_y(state, tri, xdt, B_q, C_q, Lcum):
    """One chunk's y: the quadratic form within the chunk plus the carried
    state's part.  ``y_diag``'s product comes last: a checkpoint's
    recompute stops before it (backward reads its operands, not its
    result), as XLA's remat of JAX's scan step drops it."""
    G = torch.einsum("bqn,bsn->bqs", C_q, B_q)                # [B, Q, Q]
    # the upper triangle's exponent is positive and may overflow: it is
    # masked to -inf before the exponential (exp -> 0), where the
    # reference masks the product after it
    diff = Lcum[:, :, None, :] - Lcum[:, None, :, :]          # [B, Q, S, H]
    decay = torch.exp(torch.where(tri[None, :, :, None], diff,
                                  float("-inf")))
    W = G[..., None] * decay
    y_off = torch.einsum("bqn,bhpn,bqh->bqhp", C_q, state, torch.exp(Lcum))
    return torch.einsum("bqsh,bshp->bqhp", W, xdt) + y_off


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bs: torch.Tensor, Cs: torch.Tensor, *, chunk: int,
                init_ssm: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  xh: [B, L, H, P]; dt: [B, L, H] (post-softplus);
    A: [H] (negative); Bs/Cs: [B, L, N].  Returns (y [B, L, H, P] f32,
    final state [B, H, P, N] f32)."""
    Bb, L, H, Pd = xh.shape
    N = Bs.shape[-1]
    Q = min(chunk, L)
    n_chunks = -(-L // Q)
    Lp = n_chunks * Q

    def prep(t):
        t = t.float()
        if Lp != L:
            t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, Lp - L))
        return t.reshape(Bb, n_chunks, Q, *t.shape[2:])
    xc, dtc, Bc, Cc = map(prep, (xh, dt, Bs, Cs))
    ldc = dtc * A.float()[None, None, None, :]                # [B, n, Q, H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    state = (torch.zeros((Bb, H, Pd, N), dtype=torch.float32,
                         device=xh.device)
             if init_ssm is None else init_ssm.float())
    # under autograd each chunk's y is checkpointed, as JAX's scan step is:
    # backward recomputes its [B, Q, Q, H] decay block instead of storing it
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc, dtc, Bc, Cc, ldc, state))
    ys = []
    for c in range(n_chunks):
        x_q, dt_q, B_q, C_q, ld_q = (t[:, c] for t in (xc, dtc, Bc, Cc, ldc))
        Lcum = torch.cumsum(ld_q, dim=1)                      # [B, Q, H]
        xdt = x_q * dt_q[..., None]                           # [B, Q, H, P]
        args = (state, tri, xdt, B_q, C_q, Lcum)
        ys.append(checkpoint(_chunk_y, *args, use_reentrant=False) if remat
                  else _chunk_y(*args))
        rem = torch.exp(Lcum[:, -1:, :] - Lcum)               # to chunk end
        S_c = torch.einsum("bsh,bshp,bsn->bhpn", rem, xdt, B_q)
        state = state * torch.exp(Lcum[:, -1])[:, :, None, None] + S_c
    y = torch.stack(ys, dim=1).reshape(Bb, Lp, H, Pd)[:, :L]
    return y, state


def ssd_recurrent_ref(xh, dt, A, Bs, Cs):
    """Naive per-step recurrence oracle for tests."""
    Bb, L, H, Pd = xh.shape
    N = Bs.shape[-1]
    state = torch.zeros((Bb, H, Pd, N), dtype=torch.float32,
                        device=xh.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dt[:, t] * A[None, :])                 # [B, H]
        upd = torch.einsum("bhp,bn->bhpn", xh[:, t] * dt[:, t, :, None],
                           Bs[:, t])
        state = state * dA[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cs[:, t]))
    return torch.stack(ys, dim=1), state


def mamba_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                cfg: ModelConfig, *, state: Optional[MambaState] = None,
                valid_len=None) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """x: [B, L, d] -> [B, L, d]; with ``state`` stateful (decode or
    resume), returning the new state.  ``valid_len`` ([B] or a scalar)
    marks the first ``valid_len`` positions as real tokens: pad positions
    get dt = 0 (an exact identity SSD update) and the conv states slice at
    the last valid input, so a padded final prefill chunk leaves the
    state token-exact."""
    dm = mamba_dims(cfg)
    dtype = x.dtype
    z = x @ p["wz"]
    xc = x @ p["wx"]
    Bs = x @ p["wB"]
    Cs = x @ p["wC"]
    dt = x @ p["wdt"]
    cx, cB, cC = ((None, None, None) if state is None
                  else (state.conv_x, state.conv_B, state.conv_C))
    xc, ncx = _causal_conv(xc, p["conv_x"], p["conv_bx"], cx, valid_len)
    Bs, ncB = _causal_conv(Bs, p["conv_B"], p["conv_bB"], cB, valid_len)
    Cs, ncC = _causal_conv(Cs, p["conv_C"], p["conv_bC"], cC, valid_len)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    L = x.shape[1]
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=x.device).reshape(-1) \
            .expand(x.shape[0])
        dt = dt * (torch.arange(L, device=x.device)[None, :]
                   < vl[:, None])[..., None]
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(*xc.shape[:2], dm.n_heads, dm.head_dim)

    init_ssm = state.ssm if state is not None else None
    if L == 1 and state is not None:
        # decode: one recurrence step
        dA = torch.exp(dt[:, 0] * A[None, :])                 # [B, H]
        xdt = xh[:, 0].float() * dt[:, 0, :, None]
        upd = torch.einsum("bhp,bn->bhpn", xdt, Bs[:, 0].float())
        ssm = init_ssm * dA[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", ssm, Cs[:, 0].float())[:, None]
    else:
        y, ssm = ssd_chunked(xh, dt, A, Bs.float(), Cs.float(),
                             chunk=cfg.ssm.chunk_size, init_ssm=init_ssm)
    new_state = (MambaState(ssm, ncx, ncB, ncC)
                 if state is not None else None)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(*y.shape[:2], dm.d_inner).to(dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"], new_state
