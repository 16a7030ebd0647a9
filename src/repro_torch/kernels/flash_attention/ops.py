"""Flash attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/flash_attention/`` (``flash_attention_kernel``,
``ops.flash_attention``, ``ref.flash_attention_ref``): causal or full
attention of a whole prompt over itself, forward only.  ``flash_attention``
launches ``csrc/flash_attention.cu`` for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; there is no fallback from one
to the other.  The kernel's design is chosen by ``q.dtype``, explicitly
(no input can reach both): bfloat16, the prefill path's type, runs on the
tensor cores (``wgmma``) and needs every row of q, k and v to start on 16
bytes; float32 runs on the CUDA cores, since ``wgmma``'s only f32 route
is TF32.  Either takes every head width that is a multiple of 8 up to
256 (``padded_head_dim``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widths the tensor-core design is compiled for; any hd % 8 == 0 up to
# 256 runs at the next of them, its columns past hd zero
HEAD_DIMS = (64, 128, 256)


def padded_head_dim(hd: int) -> int:
    """The kernel's domain of head widths: every multiple of 8 from 8 to
    256.  Returns the width the bf16 design is compiled for at ``hd``
    (the first of ``HEAD_DIMS`` at or above it); raises ``ValueError``
    naming the domain outside it.  At hd % 8 == 0 a 16-byte chunk of a
    bf16 row lies wholly inside hd or past it."""
    if hd % 8 or not 8 <= hd <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention kernel takes hd a multiple of 8 "
                         f"from 8 to {HEAD_DIMS[-1]}; got hd={hd}")
    return next(w for w in HEAD_DIMS if w >= hd)


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """The kernel's dynamic shared memory at ``hd`` (``csrc``'s
    ``wgmma_smem_bytes`` and ``smem_floats``): bf16, the 128-row q tile
    and the ring of 64-position K/V tile pairs at the padded width (3
    stages, 2 at 256) plus 1 KB of alignment slack; f32, q and K with a
    column of padding, V, and the 64 x 65 tile of p."""
    if dtype == torch.bfloat16:
        hdp = padded_head_dim(hd)
        stages = 2 if hdp == 256 else 3
        return 128 * hdp * 2 + 2 * stages * 64 * hdp * 2 + 1024
    return 4 * (2 * 64 * (hd + 1) + 64 * hd + 64 * 65)


def _check_causal(Sq: int, Sk: int, causal: bool) -> None:
    # The TPU kernel masks top-left (q_pos >= k_pos), its oracle bottom-right
    # (tril(k=Sk-Sq)); the two agree only for Sq == Sk, the only case called.
    if causal and Sq != Sk:
        raise ValueError(f"causal flash attention needs Sq == Sk, got "
                         f"Sq={Sq}, Sk={Sk}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Naive f32 softmax attention in the model layout (the reference the
    kernel must match, ``ref.py``): q [B, Sq, H, hd], k/v [B, Sk, Hkv, hd]
    -> [B, Sq, H, hd]; q head h reads kv head h // (H / Hkv)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_causal(Sq, Sk, causal)
    rep = H // Hkv
    qf = (q.float() * hd ** -0.5).reshape(B, Sq, Hkv, rep, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.float())
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgh->bqgrh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout entry: q [B, Sq, H, hd]; k/v [B, Sk, Hkv, hd] ->
    [B, Sq, H, hd] contiguous.  The kernel reads q, k and v in place
    through their strides (the last axis, hd, must be contiguous), so the
    JAX wrapper's transposes are not needed.  Forward only: raises when
    an input requires grad under grad mode (``build.forward_only``)."""
    build.forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_causal(Sq, Sk, causal)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes float32 or bfloat16 q and k/v "
                        "of q's dtype")
    padded_head_dim(hd)
    if H % Hkv or k.shape != (B, Sk, Hkv, hd) \
            or v.shape != k.shape or Sq == 0 or Sk == 0:
        raise ValueError(f"flash_attention kernel needs H % Hkv == 0 and "
                         f"k/v of one shape; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: k and v must be on q's device")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash_attention: the last axis (hd) of q, k "
                             "and v must be contiguous")
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))):
            raise ValueError("flash_attention: the bf16 kernel copies 16-byte "
                             "chunks, so every row of q, k and v must start "
                             "on 16 bytes (strides multiples of 8)")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, Sq, Sk, H, Hkv, hd, strides, int(causal),
                float(hd ** -0.5), stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0     # kernel launches (CUDA tensors only)
