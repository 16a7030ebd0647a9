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
// of one kv head are the rows i * rep + r of one tile, so K/V are read once
// per tile and never repeated.  Online softmax in f32; p is rounded to the
// pool's type before the P @ V product, as the TPU kernel rounds it.
//
// What bounds it: the K/V bytes of each row's live chain (decode at 4 slots
// of ~300 tokens reads ~2.4 MB per layer), so at decode it is launch- and
// latency-bound, not bandwidth-bound.
// What the design does about it: one block per (q tile, kv head, row) walks
// the chain in chunks of 32 positions staged through shared memory (no
// state carries between blocks on this card, so the TPU's sequential kv
// grid axis becomes this loop).  The chain stops at the tile's deepest
// query (causal pruning; positions past it are never loaded), entries past
// a chain's end point at the null block, which is valid memory, and any
// block_size works (odd, or 1), since a position's block is p / block_size.
// Splitting one chain over several blocks for small-batch decode is left
// for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int QT = WARPS * ROWS_PER_WARP;  // q rows per block
constexpr int KC = 32;                      // kv positions per chunk (one per lane)
constexpr int HD_MAX = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q/out [B, S, H, hd]; pools [num_blocks, bs, Hkv, hd]; bt [B, n_blocks].
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
           const int* __restrict__ bt, const int* __restrict__ cl, T* __restrict__ out,
           int S, int H, int Hkv, int hd, int bs, int n_blocks, float softcap, float scale) {
  const int t = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv, QR = S * rep, row0 = t * QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nj = hd / 32;
  __shared__ float qs[QT][HD_MAX];
  __shared__ float ks[KC][HD_MAX + 1];
  __shared__ float vs[KC][HD_MAX + 1];

  for (int i = threadIdx.x; i < QT * hd; i += blockDim.x) {
    const int r = i / hd, c = i % hd, row = row0 + r;
    float v = 0.f;
    if (row < QR) {
      const int qi = row / rep, rr = row % rep;
      v = to_f(q[(((size_t)b * S + qi) * H + g * rep + rr) * hd + c]) * scale;
    }
    qs[r][c] = v;
  }
  const int length = cl[b];
  const int last_row = min(row0 + QT, QR) - 1;
  // deepest position any query of this tile may see (causal pruning)
  const int hi = min(length - S + last_row / rep, n_blocks * bs - 1);

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][HD_MAX / 32];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < HD_MAX / 32; ++j) acc[r][j] = 0.f;
  }

  for (int p0 = 0; p0 <= hi; p0 += KC) {
    __syncthreads();  // the previous chunk (and q) are fully consumed / written
    for (int i = threadIdx.x; i < KC * hd; i += blockDim.x) {
      const int pp = i / hd, c = i % hd, p = p0 + pp;
      float kv = 0.f, vv = 0.f;
      if (p <= hi) {
        const int blk = bt[(size_t)b * n_blocks + p / bs];
        const size_t o = (((size_t)blk * bs + p % bs) * Hkv + g) * hd + c;
        kv = to_f(kp[o]);
        vv = to_f(vp[o]);
      }
      ks[pp][c] = kv;
      vs[pp][c] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr, row = row0 + r;
      if (row >= QR) break;  // warp-uniform
      const int q_pos = length - S + row / rep;
      const int p = p0 + lane;
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s = fmaf(qs[r][c], ks[lane][c], s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool valid = (S == 1) ? (p < length) : (p <= q_pos && p < length);
      s = valid ? s : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float pe = expf(s - m_new);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(pe);
      const float pr = to_f(from_f<T>(pe));  // p in the pool's type for P @ V
#pragma unroll
      for (int j = 0; j < HD_MAX / 32; ++j) acc[rr][j] *= corr;
      for (int jj = 0; jj < KC; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pr, jj);
#pragma unroll
        for (int j = 0; j < HD_MAX / 32; ++j)
          if (j < nj) acc[rr][j] = fmaf(pj, vs[jj][lane + 32 * j], acc[rr][j]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr, row = row0 + r;
    if (row >= QR) break;
    const int qi = row / rep, h = g * rep + row % rep;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* o = out + (((size_t)b * S + qi) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < HD_MAX / 32; ++j)
      if (j < nj) o[lane + 32 * j] = from_f<T>(acc[rr][j] * inv);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  The Python wrapper checks hd % 32 == 0 and
// hd <= 128, H % Hkv == 0, contiguity and int32 tables.
extern "C" int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const int* block_table,
                                      const int* cache_len, void* out, int B, int S, int H,
                                      int Hkv, int hd, int block_size, int n_blocks,
                                      float softcap, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rep = H / Hkv;
  const dim3 grid((S * rep + QT - 1) / QT, Hkv, B);
  if (dtype == 0)
    paged_attn<float><<<grid, WARPS * 32, 0, s>>>(
        (const float*)q, (const float*)k_pool, (const float*)v_pool, block_table, cache_len,
        (float*)out, S, H, Hkv, hd, block_size, n_blocks, softcap, scale);
  else
    paged_attn<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool, (const __nv_bfloat16*)v_pool,
        block_table, cache_len, (__nv_bfloat16*)out, S, H, Hkv, hd, block_size, n_blocks,
        softcap, scale);
  return (int)cudaGetLastError();
}
