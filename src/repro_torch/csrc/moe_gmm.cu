// Grouped expert FFN for Hopper (sm_90a): the port of the Pallas TPU kernel
// src/repro/kernels/moe_gmm/moe_gmm.py::moe_gmm (bodies _kernel_gated and
// _kernel_plain, wrapper kernels/moe_gmm/ops.py::fused_expert_ffn).
//
// What it computes: x [M, d] is the block-aligned dispatch buffer; row tile
// i (block_m rows) belongs to group g = tile_group[i].  For every row,
//   gated: y = (silu(x @ w_gate[g]) * (x @ w_in[g])) @ w_out[g]
//   plain: y = act(x @ w_in[g]) @ w_out[g]
// with f32 accumulation and the intermediate h rounded to x's type before
// the second product, exactly where the TPU kernel rounds (moe_gmm.py:61).
// Group g reads its weights from the local rows (g < n_local) or from the
// separate foreign rows (g - n_local), so the caller never concatenates the
// two weight sets into one copy.
//
// What bounds it: at decode the live rows are few, so the bytes of the live
// groups' weights bound it (16 live groups x 3 x 2048 x 1408 x 2 B ~ 277 MB
// per layer, ~83 us at 3.35 TB/s); most of the buffer is padding.
// What the design does about it:
//   * a first pass flags each 32-row tile that holds any non-zero value;
//     the dispatch invariant makes every other tile zero rows, whose output
//     is exact zeros (act(0) = 0), so the GEMMs write zeros there and skip
//     the products.  Within a 128-row group tile only the 32-row sub-tiles
//     holding real units are computed.
//   * the TPU kernel's [block_m, d] f32 accumulator (1 MB at d = 2048) does
//     not fit a block's 227 KB of shared memory, so the work is two
//     launches: up/gate into h [M, f] (x's type), then h @ w_out.
//   * f = 1408 is 22 tiles of 64: no ragged edge (the TPU kernel's
//     block_f = 512 does not divide it).
// This first version multiplies on the CUDA cores with f32 FMAs from
// shared-memory tiles; tensor cores (wgmma), TMA and warp specialisation
// are left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 32;   // rows per block (a sub-tile of block_m)
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // reduction depth per shared-memory stage
constexpr int NT = 256;  // threads: 16 column lanes x 16 row lanes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// act codes: 0 silu, 1 gelu (tanh approximation, jax.nn.gelu's default), 2 relu
__device__ __forceinline__ float act_fn(int act, float h) {
  if (act == 0) return h / (1.f + expf(-h));
  if (act == 1) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  return fmaxf(h, 0.f);
}

template <typename T>
__global__ void tile_live(const T* __restrict__ x, int* __restrict__ live, int d) {
  const T* base = x + (size_t)blockIdx.x * BM * d;
  int any = 0;
  for (int i = threadIdx.x; i < BM * d; i += blockDim.x) any |= (to_f(base[i]) != 0.f);
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) live[blockIdx.x] = any;
}

template <typename T>
__device__ __forceinline__ const T* group_rows(const T* local, const T* extra,
                                               int n_local, int g, size_t stride) {
  return g < n_local ? local + (size_t)g * stride : extra + (size_t)(g - n_local) * stride;
}

// h[m, n] = act-combine(x @ w_in[g], x @ w_gate[g]) for a BM x BN tile.
template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
gmm_up(const T* __restrict__ x, const T* __restrict__ w_in, const T* __restrict__ w_gate,
       const T* __restrict__ w_in_x, const T* __restrict__ w_gate_x, int n_local,
       const int* __restrict__ tile_group, const int* __restrict__ live,
       T* __restrict__ h, int d, int f, int block_m, int act) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (!live[blockIdx.y]) {
    for (int i = tid; i < BM * BN; i += NT)
      h[(size_t)(m0 + i / BN) * f + n0 + i % BN] = from_f<T>(0.f);
    return;
  }
  const int g = tile_group[m0 / block_m];
  const size_t stride = (size_t)d * f;
  const T* wi = group_rows(w_in, w_in_x, n_local, g, stride);
  const T* wg = GATED ? group_rows(w_gate, w_gate_x, n_local, g, stride) : nullptr;
  __shared__ float xs[BM][BK + 1];
  __shared__ float wis[BK][BN];
  __shared__ float wgs[GATED ? BK : 1][BN];
  float au[2][4] = {}, ag[2][4] = {};
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT)
      xs[i / BK][i % BK] = to_f(x[(size_t)(m0 + i / BK) * d + k0 + i % BK]);
    for (int i = tid; i < BK * BN; i += NT) {
      const size_t o = (size_t)(k0 + i / BN) * f + n0 + i % BN;
      wis[i / BN][i % BN] = to_f(wi[o]);
      if constexpr (GATED) wgs[i / BN][i % BN] = to_f(wg[o]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = xs[ty][kk], a1 = xs[ty + 16][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = wis[kk][tx + 16 * j];
        au[0][j] = fmaf(a0, b, au[0][j]);
        au[1][j] = fmaf(a1, b, au[1][j]);
        if constexpr (GATED) {
          const float c = wgs[kk][tx + 16 * j];
          ag[0][j] = fmaf(a0, c, ag[0][j]);
          ag[1][j] = fmaf(a1, c, ag[1][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = GATED ? act_fn(0, ag[i][j]) * au[i][j] : act_fn(act, au[i][j]);
      h[(size_t)(m0 + ty + 16 * i) * f + n0 + tx + 16 * j] = from_f<T>(v);
    }
}

// y[m, n] = h @ w_out[g] for a BM x BN tile (reduction over f).
template <typename T>
__global__ void __launch_bounds__(NT)
gmm_down(const T* __restrict__ h, const T* __restrict__ w_out, const T* __restrict__ w_out_x,
         int n_local, const int* __restrict__ tile_group, const int* __restrict__ live,
         T* __restrict__ y, int d, int f, int block_m) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (!live[blockIdx.y]) {
    for (int i = tid; i < BM * BN; i += NT)
      y[(size_t)(m0 + i / BN) * d + n0 + i % BN] = from_f<T>(0.f);
    return;
  }
  const int g = tile_group[m0 / block_m];
  const T* wo = group_rows(w_out, w_out_x, n_local, g, (size_t)f * d);
  __shared__ float hs[BM][BK + 1];
  __shared__ float ws[BK][BN];
  float acc[2][4] = {};
  for (int k0 = 0; k0 < f; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT)
      hs[i / BK][i % BK] = to_f(h[(size_t)(m0 + i / BK) * f + k0 + i % BK]);
    for (int i = tid; i < BK * BN; i += NT)
      ws[i / BN][i % BN] = to_f(wo[(size_t)(k0 + i / BN) * d + n0 + i % BN]);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = hs[ty][kk], a1 = hs[ty + 16][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = ws[kk][tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[(size_t)(m0 + ty + 16 * i) * d + n0 + tx + 16 * j] = from_f<T>(acc[i][j]);
}

template <typename T>
int launch(int gated, int act, const void* x, const void* w_in, const void* w_gate,
           const void* w_out, const void* w_in_x, const void* w_gate_x, const void* w_out_x,
           int n_local, const int* tile_group, int* live, void* h, void* y, int M, int d,
           int f, int block_m, cudaStream_t s) {
  const int n_tiles = M / BM;
  tile_live<T><<<n_tiles, 256, 0, s>>>((const T*)x, live, d);
  const dim3 grid_up(f / BN, n_tiles), grid_down(d / BN, n_tiles);
  if (gated)
    gmm_up<T, true><<<grid_up, NT, 0, s>>>((const T*)x, (const T*)w_in, (const T*)w_gate,
                                           (const T*)w_in_x, (const T*)w_gate_x, n_local,
                                           tile_group, live, (T*)h, d, f, block_m, act);
  else
    gmm_up<T, false><<<grid_up, NT, 0, s>>>((const T*)x, (const T*)w_in, nullptr,
                                            (const T*)w_in_x, nullptr, n_local, tile_group,
                                            live, (T*)h, d, f, block_m, act);
  gmm_down<T><<<grid_down, NT, 0, s>>>((const T*)h, (const T*)w_out, (const T*)w_out_x,
                                       n_local, tile_group, live, (T*)y, d, f, block_m);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Shapes are checked by the Python wrapper:
// M % block_m == 0, block_m % 32 == 0, d % 64 == 0, f % 64 == 0.
extern "C" int moe_gmm_launch(int dtype, int gated, int act, const void* x,
                              const void* w_in, const void* w_gate, const void* w_out,
                              const void* w_in_x, const void* w_gate_x, const void* w_out_x,
                              int n_local, const int* tile_group, int* live, void* h,
                              void* y, int M, int d, int f, int block_m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(gated, act, x, w_in, w_gate, w_out, w_in_x, w_gate_x, w_out_x,
                         n_local, tile_group, live, h, y, M, d, f, block_m, s);
  return launch<__nv_bfloat16>(gated, act, x, w_in, w_gate, w_out, w_in_x, w_gate_x,
                               w_out_x, n_local, tile_group, live, h, y, M, d, f, block_m, s);
}
