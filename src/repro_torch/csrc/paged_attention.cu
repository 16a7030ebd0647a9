// Paged attention for Hopper (sm_90a): the port of the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py::paged_attention_kernel
// (body _kernel; wrapper kernels/paged_attention/ops.py::paged_attention).
//
// What it computes: S queries per row b attend over that row's KV chain,
// read through block_table [B, n_blocks] from the pools
// [num_blocks, block_size, Hkv, hd].  cache_len [B] includes the S-query
// window: query i sits at position cache_len - S + i.  Masks, exactly as on
// the TPU: S == 1 keeps kv_pos < length; S > 1 keeps kv_pos <= q_pos and
// kv_pos < length; masked logits are -1e30 (not -inf) and the flush divides
// by max(l, 1e-30).  Optional logit softcap.  GQA: the rep = H / Hkv q heads
// of one kv head are the rows i * rep + r of one q tile, so K/V are read
// once per tile and never repeated.  Online softmax in f32; p is rounded to
// the pool's type before the P @ V product, as the TPU kernel rounds it,
// while l sums the unrounded p.
//
// What bounds it: the K/V bytes of each row's live chain (decode at 4 slots
// of ~300 tokens reads ~4.7 MB per layer, 1.4 us at the HBM rate), so a
// call is bound by bytes and, at the serve shapes, by its latency chain.
//
// What the design does about it (split-KV, "flash-decoding"):
//   * Each (row, kv head, q tile) chain is cut into position spans of
//     `span` positions, chosen on the host from shapes only (ops.py
//     `launch_plan`); each span is one CTA, so a 4-row decode still fills
//     the card.  Spans need not start or end on a block boundary: every
//     position looks up its own block.  cache_len is read on the device
//     only; a CTA whose span lies wholly past its tile's causal bound
//     (or its row's length) loads and computes nothing and writes the
//     empty partial m = -1e30, l = 0, acc = 0.
//   * K/V move by 16-byte cp.async copies (8 bf16 or 4 f32 a thread,
//     neighbouring threads on neighbouring addresses) into a ring of
//     stages in shared memory, kept in the pool's type; the block-table
//     lookups and copies of the next stages run while the current stage
//     is computed.
//   * Masked positions get p = 0 outright.  A span (or warp) that saw no
//     visible position therefore holds exactly (m = -1e30, l = 0,
//     acc = 0), and the TPU's sentinel trap (a fully masked tile computing
//     p = exp(0) = 1) cannot add anything.  Where a row sees at least one
//     position, the result equals the TPU kernel's, whose masked p are
//     exp(-1e30 - m) = 0 as well.
//   * Merge: each CTA writes its f32 partial (m, l, acc) to a workspace the
//     wrapper allocates; the last CTA of each (row, head, tile) group,
//     found by an atomic ticket, merges them: M = max m_s,
//     l = sum exp(m_s - M) l_s, acc = sum exp(m_s - M) acc_s, out =
//     acc / max(l, 1e-30), and resets the ticket to 0 for the next call.
//     One call is one device launch.  With one span per group the CTA
//     writes the output itself and takes no ticket.
//   * Route, picked by the wrapper from dtype and rows: a bf16 q tile of
//     >= 16 rows (S * rep: the serve prefill chunk has 32) runs on the
//     tensor cores (mma.sync m16n8k16, 16-row tiles, each warp a quarter of
//     every stage, P from registers); everything else, decode (a GEMV) and
//     every f32 tile, on the CUDA cores, each 16-byte chunk of a position
//     dotted by one lane and summed over the lanes that hold the row.
//   * Head dims: every multiple of 8 from 8 to 256, as the TPU kernel
//     takes any.  hd is carried at run time; the code is compiled for the
//     padded width HD = 32, 64, 128 or 256 (ops.py `padded_head_dim`), the
//     next at or above hd.  Shared memory holds HD columns a row: the
//     copies of q, K and V past hd are zero-filled (cp.async with
//     src-size 0 reads nothing), so the padded columns add exact zeros to
//     q k^T and to P V, and no output column past hd is written.  A 16-
//     byte chunk is 8 bf16 or 4 f32 values, so at hd % 8 == 0 every chunk
//     lies wholly inside hd or wholly past it.  At hd 112 the padding
//     costs 16 of 128 columns of arithmetic and none of HBM.
//   * At HD 256 a position's vector can be wider than a warp's 32 16-byte
//     chunks (64 chunks in f32): each lane then holds two chunks, c and
//     c + 32, and a warp one position at a time.  On the tensor cores, HD
//     256 keeps O (128 f32 a thread) in registers and reads Q's fragments
//     from shared memory at every stage instead of holding them too (64
//     more registers would spill).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::smem_addr;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLITS = 256;  // ops.py MAX_SPLITS: the merge's weights fit in shared memory
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* cl;
  void* out;
  float* ws;     // partials: acc [G * n_splits * QT * hd], then m, then l
  int* tickets;  // [G], zero between calls
  int S, H, Hkv, hd, bs, n_blocks, n_tiles, n_splits, span;  // hd: the real width
  float softcap, scale;
};

// The span of one CTA: blockIdx.x = tile * n_splits + split, y = kv head,
// z = row.  Positions lo <= p < end are loaded; end <= lo for a dead span.
struct Tile {
  int b, g, tile, split, row0, nrows, length, lo, end;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int QT) {
  Tile t;
  t.split = blockIdx.x % a.n_splits;
  t.tile = blockIdx.x / a.n_splits;
  t.g = blockIdx.y;
  t.b = blockIdx.z;
  const int rep = a.H / a.Hkv;
  t.row0 = t.tile * QT;
  t.nrows = min(QT, a.S * rep - t.row0);
  t.length = a.cl[t.b];
  // deepest position the tile's last query may see (causal pruning)
  const int hi = min(t.length - a.S + (t.row0 + t.nrows - 1) / rep,
                     a.n_blocks * a.bs - 1);
  t.lo = t.split * a.span;
  t.end = min(t.lo + a.span, hi + 1);
  return t;
}

// The masks of the TPU kernel, for tile row r at position p (lo <= p).
__device__ __forceinline__ bool visible(const Args& a, const Tile& t, int r, int p) {
  if (r >= t.nrows || p >= t.end || p >= t.length) return false;
  return a.S == 1 || p <= t.length - a.S + (t.row0 + r) / (a.H / a.Hkv);
}

// Element offset of tile row `row`'s q (and output) vector.
__device__ __forceinline__ size_t q_offset(const Args& a, const Tile& t, int row) {
  const int rep = a.H / a.Hkv;
  return (((size_t)t.b * a.S + row / rep) * a.H + t.g * rep + row % rep) * a.hd;
}

// Element offset of position p's K/V vector for the tile's kv head.
__device__ __forceinline__ size_t kv_offset(const Args& a, const Tile& t, int p) {
  const int blk = __ldg(a.bt + (size_t)t.b * a.n_blocks + p / a.bs);
  return (((size_t)blk * a.bs + p % a.bs) * a.Hkv + t.g) * a.hd;
}

__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// p as the P @ V product sees it: rounded to the pool's type
template <typename T> __device__ __forceinline__ float rounded(float v) {
  return (float)from_f<T>(v);
}

__device__ __forceinline__ float capped(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// Four output elements of a row: scaled, rounded to T and stored together.
__device__ __forceinline__ void store4(float* p, float4 v, float s) {
  *reinterpret_cast<float4*>(p) = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, float s) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * s, v.y * s);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * s, v.w * s);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void fma4(float4& acc, float c, float4 v) {
  acc.x = fmaf(c, v.x, acc.x);
  acc.y = fmaf(c, v.y, acc.y);
  acc.z = fmaf(c, v.z, acc.z);
  acc.w = fmaf(c, v.w, acc.w);
}

// Combine the WARPS per-warp states of the CTA (st: m [WARPS][QT], l
// [WARPS][QT], acc [WARPS][QT][HD] in shared memory; HD the padded width,
// of which the first a.hd columns are written out), then either write the
// output (one span a group) or write the CTA's partial and, in the group's
// last CTA, merge all partials into the output.  Each thread handles
// quads of four neighbouring elements of a row; every load of a phase is
// independent of the others, so a thread keeps them all in flight.
template <typename T, int QT, int HD>
__device__ void finish(const Args& a, const Tile& t, float* st) {
  constexpr int NQ = QT * HD / 4, QPT = (NQ + THREADS - 1) / THREADS;
  __shared__ float cw[WARPS][QT], rm[QT], rl[QT];
  __shared__ int last;
  T* out = static_cast<T*>(a.out);
  const float* wm = st;
  const float* wl = st + WARPS * QT;
  const float* wacc = st + 2 * WARPS * QT;
  if (threadIdx.x < QT) {  // each row's weights over the warps
    const int r = threadIdx.x;
    float M = NEG_INF, l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w * QT + r]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      cw[w][r] = expf(wm[w * QT + r] - M);  // 0 for a warp that saw nothing
      l += cw[w][r] * wl[w * QT + r];
    }
    rm[r] = M;
    rl[r] = l;
  }
  __syncthreads();
  const int NS = a.n_splits;
  const size_t G = (size_t)(gridDim.x / NS) * gridDim.y * gridDim.z;
  const int gidx = (t.b * a.Hkv + t.g) * a.n_tiles + t.tile;
  const size_t p0 = (size_t)gidx * NS * QT;  // the group's first partial row
  float* part_acc = a.ws;
  float* part_m = a.ws + G * NS * QT * HD;
  float* part_l = part_m + G * NS * QT;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int e = 4 * (threadIdx.x + i * THREADS), r = e / HD, d = e % HD;
    if (e >= QT * HD || r >= t.nrows) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      fma4(acc, cw[w][r], *reinterpret_cast<const float4*>(wacc + (w * QT + r) * HD + d));
    if (NS == 1) {
      if (d < a.hd) store4(out + q_offset(a, t, t.row0 + r) + d, acc, 1.f / fmaxf(rl[r], 1e-30f));
    } else
      *reinterpret_cast<float4*>(part_acc + (p0 + (size_t)t.split * QT + r) * HD + d) = acc;
  }
  if (NS == 1) return;
  if (threadIdx.x < t.nrows) {
    part_m[p0 + t.split * QT + threadIdx.x] = rm[threadIdx.x];
    part_l[p0 + t.split * QT + threadIdx.x] = rl[threadIdx.x];
  }
  __threadfence();  // this CTA's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + gidx, 1) == NS - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The group's last CTA.  st is free again: it holds the spans' m, then
  // their weights, w [NS][QT], their l [NS][QT], the merged l [QT] and the
  // lanes' sums [THREADS] float4 (<= 2 MAX_SPLITS QT + QT + 4 THREADS + 3
  // floats).
  float* w = st;
  float* ls = w + NS * QT;
  float* lt = ls + NS * QT;
  for (int i = threadIdx.x; i < NS * QT; i += THREADS) {
    w[i] = __ldcg(part_m + p0 + i);
    ls[i] = __ldcg(part_l + p0 + i);
  }
  __syncthreads();
  if (threadIdx.x < QT) {
    const int r = threadIdx.x;
    float M = NEG_INF;
    for (int s = 0; s < NS; ++s) M = fmaxf(M, w[s * QT + r]);
    float l = 0.f;
    for (int s = 0; s < NS; ++s) {
      const float c = expf(w[s * QT + r] - M);  // 0 for a span that saw nothing
      w[s * QT + r] = c;
      l += c * ls[s * QT + r];
    }
    lt[r] = l;
  }
  __syncthreads();
  // Quads x spans over the threads: NQC quads at a time, and SL lanes of
  // spans when a tile has fewer quads than threads (decode: 32 quads, 4
  // lanes), summed through shared memory after the loads.
  constexpr int NQC = NQ < THREADS ? NQ : THREADS, SL = THREADS / NQC;
  const int sl = threadIdx.x / NQC, q0 = threadIdx.x % NQC;
  float4 acc[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = sl; s < NS; s += SL) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int e = 4 * (q0 + i * NQC), r = e / HD;
      if (e < QT * HD && r < t.nrows)
        fma4(acc[i], w[s * QT + r],
             __ldcg(reinterpret_cast<const float4*>(part_acc + (p0 + s * QT) * HD + e)));
    }
  }
  if constexpr (SL > 1) {  // QPT == 1 here
    float4* red = reinterpret_cast<float4*>(st + ((2 * NS * QT + QT + 3) & ~3));
    red[threadIdx.x] = acc[0];
    __syncthreads();
    if (sl > 0) return;
#pragma unroll
    for (int j = 1; j < SL; ++j) {
      const float4 v = red[j * NQC + q0];
      acc[0].x += v.x; acc[0].y += v.y; acc[0].z += v.z; acc[0].w += v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int e = 4 * (q0 + i * NQC), r = e / HD;
    if (e < QT * HD && r < t.nrows && e % HD < a.hd)
      store4(out + q_offset(a, t, t.row0 + r) + e % HD, acc[i], 1.f / fmaxf(lt[r], 1e-30f));
  }
  if (threadIdx.x == 0) a.tickets[gidx] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// CUDA cores: decode (GEMV) and every f32 tile.  A position's vector is CH
// 16-byte chunks of the padded width (those past hd zero); a lane group of LPP = min(CH, 32) lanes holds it, lane c
// its chunks c + i LPP (i < CPL = CH / LPP: two at hd 256 in f32, else
// one).  A warp holds NPW = 32 / LPP positions at a time and walks J = 4 of
// them a stage, so a stage is KC = 16 NPW positions (16 KB of K and V, 32
// KB at hd 256 in f32).  Each lane group keeps its own online softmax over
// its positions; the groups, then the warps, are merged at the end.
// ---------------------------------------------------------------------------
template <typename T, int HD>
struct CudaCoreShape {
  static constexpr int VEC = 16 / sizeof(T), CH = HD / VEC, LPP = CH < 32 ? CH : 32,
                       CPL = CH / LPP, NPW = 32 / LPP, J = 4, KC = WARPS * NPW * J,
                       STAGES = 4;
  static_assert(CH % LPP == 0 && 32 % LPP == 0, "a position's chunks split over its lanes");
};

template <typename T, int HD, int QT>
__global__ void __launch_bounds__(THREADS) pa_cuda_cores(const Args a) {
  using Sh = CudaCoreShape<T, HD>;
  constexpr int VEC = Sh::VEC, CH = Sh::CH, LPP = Sh::LPP, CPL = Sh::CPL, NPW = Sh::NPW;
  constexpr int J = Sh::J, KC = Sh::KC, STAGES = Sh::STAGES, PER = KC * CH / THREADS;
  extern __shared__ __align__(16) unsigned char smem_cc[];
  unsigned char* smem = smem_cc;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + STAGES * KC * HD;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  const Tile t = tile_of(a, QT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pg = lane / LPP, c = lane % LPP;

  float qf[QT][CPL][VEC];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      if (r < t.nrows && (c + i * LPP) * VEC < a.hd) {
        load16(q + q_offset(a, t, t.row0 + r) + (c + i * LPP) * VEC, qf[r][i]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) qf[r][i][v] *= a.scale;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) qf[r][i][v] = 0.f;
      }
    }
  }
  const int nst = t.end > t.lo ? (t.end - t.lo + KC - 1) / KC : 0;
  auto load_stage = [&](int k) {
    const int slot = k % STAGES, base = t.lo + k * KC;
    const int ch = threadIdx.x % CH;  // the chunk this thread copies
    const bool real = ch * VEC < a.hd;  // else padding: zero-filled
    size_t off[PER];  // every block-table read in flight before any copy
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = base + (threadIdx.x + i * THREADS) / CH;
      off[i] = p < t.end && real ? kv_offset(a, t, p) + ch * VEC : 0;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int pp = (threadIdx.x + i * THREADS) / CH;
      const bool ok = base + pp < t.end && real;
      const size_t dst = ((size_t)slot * KC + pp) * HD + ch * VEC;
      cp_async16(smem_addr(ks + dst), kp + off[i], ok);
      cp_async16(smem_addr(vs + dst), vp + off[i], ok);
    }
  };

  float m[QT], l[QT], acc[QT][CPL][VEC];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][i][v] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nst) load_stage(k);
    hopper::cp_async_commit();
  }
  for (int k = 0; k < nst; ++k) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage k landed; the slot refilled below is consumed
    if (k + STAGES - 1 < nst) load_stage(k + STAGES - 1);
    hopper::cp_async_commit();
    const int slot = k % STAGES, base = t.lo + k * KC;
    if (base + warp * NPW * J >= t.end) continue;  // warp-uniform: no live position
    float s[J][QT];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pp = warp * NPW * J + j * NPW + pg, p = base + pp;
      float kf[CPL][VEC];
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        load16(ks + ((size_t)slot * KC + pp) * HD + (c + i * LPP) * VEC, kf[i]);
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i)
#pragma unroll
          for (int v = 0; v < VEC; ++v) x = fmaf(qf[r][i][v], kf[i][v], x);
#pragma unroll
        for (int o = LPP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        s[j][r] = visible(a, t, r, p) ? capped(x, a.softcap) : NEG_INF;
      }
    }
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < J; ++j) mx = fmaxf(mx, s[j][r]);
      const float m_new = fmaxf(m[r], mx), corr = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][i][v] *= corr;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pp = warp * NPW * J + j * NPW + pg, p = base + pp;
      float vf[CPL][VEC];
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        load16(vs + ((size_t)slot * KC + pp) * HD + (c + i * LPP) * VEC, vf[i]);
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        const float pe = visible(a, t, r, p) ? expf(s[j][r] - m[r]) : 0.f;
        l[r] += pe;
        const float pr = rounded<T>(pe);
#pragma unroll
        for (int i = 0; i < CPL; ++i)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][i][v] = fmaf(pr, vf[i][v], acc[r][i][v]);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the per-warp states below

  // merge the lane groups of the warp (same chunks, other positions)
#pragma unroll
  for (int o = LPP; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float M = fmaxf(m[r], mo), ca = expf(m[r] - M), cb = expf(mo - M);
      l[r] = ca * l[r] + cb * lo;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[r][i][v] = ca * acc[r][i][v] + cb * __shfl_xor_sync(0xffffffffu, acc[r][i][v], o);
      m[r] = M;
    }
  }
  float* st = reinterpret_cast<float*>(smem);
  float* wm = st;
  float* wl = wm + WARPS * QT;
  float* wacc = wl + WARPS * QT;
  if (pg == 0) {
#pragma unroll
    for (int r = 0; r < QT; ++r) {
#pragma unroll
      for (int i = 0; i < CPL; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          wacc[(warp * QT + r) * HD + (c + i * LPP) * VEC + v] = acc[r][i][v];
      if (c == 0) {
        wm[warp * QT + r] = m[r];
        wl[warp * QT + r] = l[r];
      }
    }
  }
  __syncthreads();
  finish<T, QT, HD>(a, t, st);
}

// ---------------------------------------------------------------------------
// Tensor cores (bf16, q tiles of 16 rows): mma.sync m16n8k16.  Stages of
// KC = 64 positions in the 128-byte swizzled layout of hopper.cuh, three
// in the ring; warp w takes positions 16 w .. 16 w + 15 of each stage:
// S = Q K^T as two n8 tiles (Q's fragments stay in registers for the whole
// span), the online softmax on the accumulator fragments, then P, packed
// to bf16 in place, is the A operand of O += P V (V through ldmatrix.trans).
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(THREADS) pa_tensor_cores(const Args a) {
  using T = __nv_bfloat16;
  constexpr int QT = 16, KC = 64, STAGES = 3, NB = (HD + 63) / 64, CHR = HD / 8;
  constexpr int PER = KC * CHR / THREADS;  // 16-byte chunks a thread copies a stage
  constexpr int Q_BYTES = QT * 128 * NB, KV_BYTES = KC * 128 * NB;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const uint32_t qs = smem_addr(smem);
  const uint32_t ks0 = qs + Q_BYTES, vs0 = ks0 + STAGES * KV_BYTES;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  const Tile t = tile_of(a, QT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < QT * CHR; i += THREADS) {
    const int r = i / CHR, cc = i % CHR;
    const bool ok = r < t.nrows && cc * 8 < a.hd;  // columns past hd: zeros
    cp_async16(qs + hopper::sw128(r, cc * 8, QT),
               q + (ok ? q_offset(a, t, t.row0 + r) + cc * 8 : 0), ok);
  }
  const int nst = t.end > t.lo ? (t.end - t.lo + KC - 1) / KC : 0;
  auto load_stage = [&](int k) {
    const uint32_t kst = ks0 + (k % STAGES) * KV_BYTES, vst = vs0 + (k % STAGES) * KV_BYTES;
    const int base = t.lo + k * KC;
    size_t off[PER];  // every block-table read in flight before any copy
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * THREADS, p = base + c / CHR;
      off[i] = p < t.end && c % CHR * 8 < a.hd ? kv_offset(a, t, p) + c % CHR * 8 : 0;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * THREADS, pp = c / CHR;
      const uint32_t o = hopper::sw128(pp, c % CHR * 8, KC);
      const bool ok = base + pp < t.end && c % CHR * 8 < a.hd;  // past hd: zeros
      cp_async16(kst + o, kp + off[i], ok);
      cp_async16(vst + o, vp + off[i], ok);
    }
  };

  // Q's fragments: held in registers for the whole span up to hd 128; at
  // hd 256 read from shared memory at every stage (O takes the registers)
  constexpr bool Q_REGS = HD <= 128;
  uint32_t qa[Q_REGS ? HD / 16 : 1][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {  // q rides in the first group
    if (k < nst) load_stage(k);
    hopper::cp_async_commit();
  }
  for (int k = 0; k < nst; ++k) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (k + STAGES - 1 < nst) load_stage(k + STAGES - 1);
    hopper::cp_async_commit();
    if constexpr (Q_REGS) {
      if (k == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          hopper::ldmatrix_x4(qa[kk], qs + hopper::sw128(lane % 16, kk * 16 + (lane / 16) * 8, QT));
      }
    }
    const int base = t.lo + k * KC + warp * 16;
    if (base >= t.end) continue;  // warp-uniform: no live position
    const uint32_t kst = ks0 + (k % STAGES) * KV_BYTES, vst = vs0 + (k % STAGES) * KV_BYTES;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < HD / 32; ++k2) {
      uint32_t qk[2][4];  // Q's fragments of columns 32 k2 .. 32 k2 + 31
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (Q_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qk[h][e] = qa[2 * k2 + h][e];
        } else {
          hopper::ldmatrix_x4(
              qk[h], qs + hopper::sw128(lane % 16, (2 * k2 + h) * 16 + (lane / 16) * 8, QT));
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        hopper::ldmatrix_x4(
            b, kst + hopper::sw128(warp * 16 + j * 8 + lane % 8, k2 * 32 + (lane / 8) * 8, KC));
        hopper::mma_16816(s[j], qk[0], b[0], b[1]);
        hopper::mma_16816(s[j], qk[1], b[2], b[3]);
      }
    }
    float pe[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment rows lane / 4 and lane / 4 + 8
      const int r = lane / 4 + 8 * h;
      bool vis[2][2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = base + j * 8 + 2 * (lane % 4) + i;
          vis[j][i] = visible(a, t, r, p);
          const float x = capped(s[j][2 * h + i] * a.scale, a.softcap);
          s[j][2 * h + i] = vis[j][i] ? x : NEG_INF;
          mx = fmaxf(mx, s[j][2 * h + i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx), corr = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x = vis[j][i] ? expf(s[j][2 * h + i] - m_new) : 0.f;
          pe[j][2 * h + i] = x;
          l[h] += x;  // this thread's share of the row sum, unrounded
        }
    }
    const uint32_t pa[4] = {hopper::pack_bf16(pe[0][0], pe[0][1]),
                            hopper::pack_bf16(pe[0][2], pe[0][3]),
                            hopper::pack_bf16(pe[1][0], pe[1][1]),
                            hopper::pack_bf16(pe[1][2], pe[1][3])};
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t b[4];
      hopper::ldmatrix_x4_trans(
          b, vst + hopper::sw128(warp * 16 + lane % 8 + ((lane / 8) & 1) * 8,
                                 n2 * 16 + (lane / 16) * 8, KC));
      hopper::mma_16816(acc[2 * n2], pa, b[0], b[1]);
      hopper::mma_16816(acc[2 * n2 + 1], pa, b[2], b[3]);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the per-warp states below

  float* st = reinterpret_cast<float*>(smem);
  float* wm = st;
  float* wl = wm + WARPS * QT;
  float* wacc = wl + WARPS * QT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane / 4 + 8 * h;
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (lane % 4 == 0) {
      wm[warp * QT + r] = m[h];
      wl[warp * QT + r] = l[h];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + 2 * (lane % 4);
      wacc[(warp * QT + r) * HD + d] = acc[n][2 * h];
      wacc[(warp * QT + r) * HD + d + 1] = acc[n][2 * h + 1];
    }
  }
  __syncthreads();
  finish<T, QT, HD>(a, t, st);
}

// the ring of K and V stages, KC positions of HD elements each
template <typename T, int HD>
constexpr int cuda_core_smem() {
  using Sh = CudaCoreShape<T, HD>;
  return Sh::STAGES * 2 * Sh::KC * HD * (int)sizeof(T);
}
// the q tile and 3 stages of K and V, 64 positions, in the swizzled layout
// (204,800 bytes at hd 256: one CTA an SM)
template <int HD>
constexpr int tensor_core_smem() {
  return (16 + 2 * 3 * 64) * 128 * ((HD + 63) / 64);
}

// Launch one instantiation, raising its dynamic shared-memory limit once.
template <auto Kernel, int SMEM>
int launch(dim3 grid, cudaStream_t s, const Args& a) {
  static bool ready = false;  // one flag per instantiation
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  Kernel<<<grid, THREADS, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_cuda_cores(int qt, dim3 grid, cudaStream_t s, const Args& a) {
  constexpr int smem = cuda_core_smem<T, HD>();
  switch (qt) {
    case 1: return launch<pa_cuda_cores<T, HD, 1>, smem>(grid, s, a);
    case 2: return launch<pa_cuda_cores<T, HD, 2>, smem>(grid, s, a);
    case 4: return launch<pa_cuda_cores<T, HD, 4>, smem>(grid, s, a);
    case 8: return launch<pa_cuda_cores<T, HD, 8>, smem>(grid, s, a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_cuda_cores(int hdp, int qt, dim3 grid, cudaStream_t s, const Args& a) {
  switch (hdp) {
    case 32: return launch_cuda_cores<T, 32>(qt, grid, s, a);
    case 64: return launch_cuda_cores<T, 64>(qt, grid, s, a);
    case 128: return launch_cuda_cores<T, 128>(qt, grid, s, a);
    case 256: return launch_cuda_cores<T, 256>(qt, grid, s, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  tensor_cores: 1 for a bf16 q tile of 16
// rows (qt must be 16), 0 for the CUDA cores (qt 1, 2, 4 or 8).  hd is the
// real head width (a multiple of 8), hdp the padded one the code was
// compiled for (32, 64, 128 or 256, at least hd), which also sizes ws's
// rows.  The grid is (n_tiles * n_splits, Hkv, B); ws and tickets are
// read only when n_splits > 1.  The Python wrapper checks the head-width
// domain (ops.py `padded_head_dim`), H % Hkv, contiguity, 16-byte
// alignment and int32 tables.
extern "C" int paged_attention_launch(int dtype, int tensor_cores, int qt, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const int* block_table, const int* cache_len, void* out,
                                      float* ws, int* tickets, int B, int S, int H, int Hkv,
                                      int hd, int hdp, int block_size, int n_blocks,
                                      int n_tiles, int n_splits, int span, float softcap,
                                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Args a{q,  k_pool,   v_pool,  block_table, cache_len, out,      ws,
               tickets, S, H, Hkv, hd, block_size, n_blocks, n_tiles, n_splits, span,
               softcap, scale};
  const dim3 grid(n_tiles * n_splits, Hkv, B);
  if (n_splits < 1 || n_splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if (hd < 8 || hd % 8 || hd > hdp) return (int)cudaErrorInvalidValue;
  if (tensor_cores) {
    if (dtype != 1 || qt != 16) return (int)cudaErrorInvalidValue;
    switch (hdp) {
      case 32: return launch<pa_tensor_cores<32>, tensor_core_smem<32>()>(grid, s, a);
      case 64: return launch<pa_tensor_cores<64>, tensor_core_smem<64>()>(grid, s, a);
      case 128: return launch<pa_tensor_cores<128>, tensor_core_smem<128>()>(grid, s, a);
      case 256: return launch<pa_tensor_cores<256>, tensor_core_smem<256>()>(grid, s, a);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_cuda_cores<float>(hdp, qt, grid, s, a);
  return launch_cuda_cores<__nv_bfloat16>(hdp, qt, grid, s, a);
}
