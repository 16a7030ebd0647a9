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
// Group g reads its weights from one of three separate sources, in group
// order: the local rows (g < n_local), the replica rows (g - n_local, for
// n_local <= g < n_local + n_rep: hot experts' copies, serve/rebalance.py)
// and the foreign rows (g - n_local - n_rep), so the caller never
// concatenates the weight sets into one copy (at qwen's width that would
// copy every rank's 15 local experts, 17.3 MB each, at every call).  With
// n_rep = 0 the replica source is never read.  The TPU kernel's [block_m, d] f32
// accumulator (1 MB at d = 2048) does not fit a block's 227 KB of shared
// memory, so the work is two launches: up/gate into h [M, f] (x's type),
// then h @ w_out.  Two designs, chosen by dtype (no input reaches both):
//
// bf16 (gmm_wgmma), the type of both main paths.  What bounds it: at the
// whole-prompt shape (moonshot, M 39,424, 24,576 units on 64 experts, d
// 2048, f 1408) operations and bytes alike: 425 GFLOP (0.43 ms at 989
// TFLOP/s) and 1.38 GB of live weights, x's live rows and y (0.41 ms at
// 3.35 TB/s).  At decode (qwen, M 8320, 16 live groups of one row) the live
// groups' weights: 277 MB of 319 MB moved, 0.095 ms.  Design: a block of
// one or two consumer warpgroups (64 rows each) computes a 128 (or 64) x
// 128 output tile on the tensor cores, wgmma m64n128k16 with f32
// accumulators, A (x or h) K-major and the weights N-major, both from
// shared memory.  The operands go through a ring of 64-deep stages (4 for
// the gated up launch, whose stage holds x, w_in and w_gate tiles, 6 for
// the others; 192 KB) filled by 16-byte cp.async copies in the 128-byte
// swizzle, the copies for stage k + stages - 2 in flight while the
// products of stage k and k - 1 run.  The gated up launch keeps two
// accumulators (up, gate) and applies silu(gate) * up in f32 before
// rounding h.  An N tail (f % 128 == 64) is zero-filled on load and not
// stored.  Grid: output column tiles fastest, so the blocks of one row tile
// run together and share its x tile in L2, and the few row tiles of one
// group follow each other while that group's weights are in L2; at decode
// each live group is one row tile, so its weights are read from HBM once.
// Liveness without a scan: group extents are rounded up to block_m, so
// every tile below live_rows = min(sum(group_sizes_padded), M) holds a real
// row and every tile at or above it is zero rows (core/dispatch.py).  The
// wrapper passes that count as a one-element device tensor; dead tiles
// skip their products, the up launch leaves their h unwritten (never
// read) and the down launch writes their y as zeros (act(0) = 0).
// Without the count every tile is live, which is still exact.
//
// f32 (gmm_up / gmm_down), for the f32 parity checks: the CUDA-core
// kernels of the first port, their arithmetic unchanged.  A first pass
// flags each 32-row tile of x that holds a non-zero value; 32 x 64 output
// tiles multiply with f32 FMAs from shared-memory tiles 32 deep, skipping
// unflagged tiles.  wgmma has no f32 x f32 form (its f32 route is TF32).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 32;   // rows per block (a sub-tile of block_m)
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // reduction depth per shared-memory stage
constexpr int NT = 256;  // threads: 16 column lanes x 16 row lanes

// act codes: 0 silu, 1 gelu (tanh approximation, jax.nn.gelu's default), 2 relu
__device__ __forceinline__ float act_fn(int act, float h) {
  if (act == 0) return h / (1.f + expf(-h));
  if (act == 1) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  return fmaxf(h, 0.f);
}

__global__ void tile_live(const float* __restrict__ x, int* __restrict__ live, int d) {
  const float* base = x + (size_t)blockIdx.x * BM * d;
  int any = 0;
  for (int i = threadIdx.x; i < BM * d; i += blockDim.x) any |= (base[i] != 0.f);
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) live[blockIdx.x] = any;
}

// One weight matrix's three sources: local | replica | foreign (extra).
template <typename T>
struct Src {
  const T* local;
  const T* rep;
  const T* extra;
};

template <typename T>
__device__ __forceinline__ const T* group_rows(Src<T> w, int n_local, int n_rep, int g,
                                               size_t stride) {
  if (g < n_local) return w.local + (size_t)g * stride;
  g -= n_local;
  if (g < n_rep) return w.rep + (size_t)g * stride;
  return w.extra + (size_t)(g - n_rep) * stride;
}

// h[m, n] = act-combine(x @ w_in[g], x @ w_gate[g]) for a BM x BN tile.
template <bool GATED>
__global__ void __launch_bounds__(NT)
gmm_up(const float* __restrict__ x, Src<float> w_in, Src<float> w_gate, int n_local,
       int n_rep, const int* __restrict__ tile_group, const int* __restrict__ live,
       float* __restrict__ h, int d, int f, int block_m, int act) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (!live[blockIdx.y]) {
    for (int i = tid; i < BM * BN; i += NT)
      h[(size_t)(m0 + i / BN) * f + n0 + i % BN] = 0.f;
    return;
  }
  const int g = tile_group[m0 / block_m];
  const size_t stride = (size_t)d * f;
  const float* wi = group_rows(w_in, n_local, n_rep, g, stride);
  const float* wg = GATED ? group_rows(w_gate, n_local, n_rep, g, stride) : nullptr;
  __shared__ float xs[BM][BK + 1];
  __shared__ float wis[BK][BN];
  __shared__ float wgs[GATED ? BK : 1][BN];
  float au[2][4] = {}, ag[2][4] = {};
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT)
      xs[i / BK][i % BK] = x[(size_t)(m0 + i / BK) * d + k0 + i % BK];
    for (int i = tid; i < BK * BN; i += NT) {
      const size_t o = (size_t)(k0 + i / BN) * f + n0 + i % BN;
      wis[i / BN][i % BN] = wi[o];
      if constexpr (GATED) wgs[i / BN][i % BN] = wg[o];
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
      h[(size_t)(m0 + ty + 16 * i) * f + n0 + tx + 16 * j] = v;
    }
}

// y[m, n] = h @ w_out[g] for a BM x BN tile (reduction over f).
__global__ void __launch_bounds__(NT)
gmm_down(const float* __restrict__ h, Src<float> w_out, int n_local, int n_rep,
         const int* __restrict__ tile_group, const int* __restrict__ live,
         float* __restrict__ y, int d, int f, int block_m) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (!live[blockIdx.y]) {
    for (int i = tid; i < BM * BN; i += NT)
      y[(size_t)(m0 + i / BN) * d + n0 + i % BN] = 0.f;
    return;
  }
  const int g = tile_group[m0 / block_m];
  const float* wo = group_rows(w_out, n_local, n_rep, g, (size_t)f * d);
  __shared__ float hs[BM][BK + 1];
  __shared__ float ws[BK][BN];
  float acc[2][4] = {};
  for (int k0 = 0; k0 < f; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT)
      hs[i / BK][i % BK] = h[(size_t)(m0 + i / BK) * f + k0 + i % BK];
    for (int i = tid; i < BK * BN; i += NT)
      ws[i / BN][i % BN] = wo[(size_t)(k0 + i / BN) * d + n0 + i % BN];
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
      y[(size_t)(m0 + ty + 16 * i) * d + n0 + tx + 16 * j] = acc[i][j];
}

int launch_f32(int gated, int act, const float* x, Src<float> w_in, Src<float> w_gate,
               Src<float> w_out, int n_local, int n_rep, const int* tile_group, int* live,
               float* h, float* y, int M, int d, int f, int block_m, cudaStream_t s) {
  const int n_tiles = M / BM;
  tile_live<<<n_tiles, 256, 0, s>>>(x, live, d);
  const dim3 grid_up(f / BN, n_tiles), grid_down(d / BN, n_tiles);
  if (gated)
    gmm_up<true><<<grid_up, NT, 0, s>>>(x, w_in, w_gate, n_local, n_rep, tile_group, live, h,
                                        d, f, block_m, act);
  else
    gmm_up<false><<<grid_up, NT, 0, s>>>(x, w_in, w_gate, n_local, n_rep, tile_group, live,
                                         h, d, f, block_m, act);
  gmm_down<<<grid_down, NT, 0, s>>>(h, w_out, n_local, n_rep, tile_group, live, y, d, f,
                                    block_m);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int TN = 128;  // output columns per block
constexpr int TK = 64;   // reduction depth per stage

template <int MT, int NB>  // MT rows per block (64 per warpgroup); NB weight operands
struct Gmm {
  static constexpr int THREADS = MT / 64 * 128;
  static constexpr int A_BYTES = MT * TK * 2;
  static constexpr int B_BYTES = TK * TN * 2;
  static constexpr int STAGE = A_BYTES + NB * B_BYTES;
  static constexpr int STAGES = NB == 2 ? 4 : 6;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

// c[m0:m0+MT, n0:n0+TN] of a @ b0[g] (and a @ b1[g]); a [M, K], b [G, K, N],
// c [M, N].  EPI 0: c = acc (down); 1: c = act(acc) (plain up); 2: c =
// silu(acc of b1) * acc of b0 (gated up, b0 = w_in, b1 = w_gate).
template <int MT, int NB, int EPI>
__global__ void __launch_bounds__(Gmm<MT, NB>::THREADS, 1)
gmm_wgmma(const __nv_bfloat16* __restrict__ a, Src<__nv_bfloat16> b0,
          Src<__nv_bfloat16> b1, int n_local, int n_rep,
          const int* __restrict__ tile_group, const int* __restrict__ live_rows,
          __nv_bfloat16* __restrict__ c, int K, int N, int block_m, int act) {
  using namespace hopper;
  using C = Gmm<MT, NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * MT;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  if (live_rows != nullptr && m0 >= *live_rows) {  // zero rows only
    if (EPI == 0)
      for (int i = tid; i < MT * TN / 8; i += C::THREADS) {
        const int r = i / (TN / 8), col = n0 + (i % (TN / 8)) * 8;
        if (col < N)
          *reinterpret_cast<uint4*>(c + (size_t)(m0 + r) * N + col) = make_uint4(0, 0, 0, 0);
      }
    return;
  }
  const int g = tile_group[m0 / block_m];
  const __nv_bfloat16* w0 = group_rows(b0, n_local, n_rep, g, (size_t)K * N);
  const __nv_bfloat16* w1 = NB == 2 ? group_rows(b1, n_local, n_rep, g, (size_t)K * N) : w0;
  const __nv_bfloat16* a_tile = a + (size_t)m0 * K;

  auto load = [&](int kt) {
    const uint32_t st = s0 + (kt % C::STAGES) * C::STAGE;
    const int k0 = kt * TK;
    for (int i = tid; i < MT * TK / 8; i += C::THREADS) {  // A: MT rows x 64, K-major
      const int r = i / (TK / 8), cc = (i % (TK / 8)) * 8;
      cp_async16(st + sw128(r, cc, MT), a_tile + (size_t)r * K + k0 + cc, true);
    }
    for (int i = tid; i < TK * TN / 8; i += C::THREADS) {  // B: 64 K rows x 128, N-major
      const int r = i / (TN / 8), cc = (i % (TN / 8)) * 8, col = n0 + cc;
      const bool ok = col < N;                              // the N tail reads zeros
      const size_t o = (size_t)(k0 + r) * N + col;
      const uint32_t dst = st + C::A_BYTES + sw128(r, cc, TK);
      cp_async16(dst, ok ? w0 + o : w0, ok);
      if constexpr (NB == 2) cp_async16(dst + C::B_BYTES, ok ? w1 + o : w1, ok);
    }
  };

  constexpr int AHEAD = C::STAGES - 2;  // stages in flight ahead of the products
  const int nk = K / TK;
  for (int kt = 0; kt < AHEAD; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  float acc0[64], acc1[NB == 2 ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (NB == 2 ? 64 : 1); ++i) acc1[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<AHEAD - 1>();  // stage kt has landed
    fence_proxy_async();
    __syncthreads();             // ... for every thread; products of kt - 2 are done
    if (kt + AHEAD < nk) load(kt + AHEAD);
    cp_async_commit();
    const uint32_t st = s0 + (kt % C::STAGES) * C::STAGE;
    reg_fence(acc0);
    if constexpr (NB == 2) reg_fence(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t da = desc(st + wg * (64 * 128) + kk * 32, 16, 1024);
      const uint32_t bb = st + C::A_BYTES + kk * (16 * 128);
      wgmma_ss_n128<1>(acc0, da, desc(bb, TK * 128, 1024), 1);
      if constexpr (NB == 2) wgmma_ss_n128<1>(acc1, da, desc(bb + C::B_BYTES, TK * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();             // the products of kt - 1 are done
    reg_fence(acc0);
    if constexpr (NB == 2) reg_fence(acc1);
  }
  wgmma_wait<0>();
  reg_fence(acc0);
  if constexpr (NB == 2) reg_fence(acc1);

  const int r0 = m0 + wg * 64;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = r0 + frag_row(wt, i), col = n0 + frag_col(wt, i);
    if (col >= N) continue;
    float v0 = acc0[i], v1 = acc0[i + 1];
    if constexpr (EPI == 1) {
      v0 = act_fn(act, v0);
      v1 = act_fn(act, v1);
    } else if constexpr (EPI == 2) {
      v0 = act_fn(0, acc1[i]) * v0;
      v1 = act_fn(0, acc1[i + 1]) * v1;
    }
    *reinterpret_cast<__nv_bfloat162*>(c + (size_t)row * N + col) =
        __floats2bfloat162_rn(v0, v1);
  }
}

using Bf16 = Src<__nv_bfloat16>;

template <int MT, int NB, int EPI>
cudaError_t launch_gmm(dim3 grid, cudaStream_t s, const void* a, Bf16 b0, Bf16 b1,
                       int n_local, int n_rep, const int* tile_group, const int* live_rows,
                       void* c, int K, int N, int block_m, int act) {
  using C = Gmm<MT, NB>;
  static bool ready = false;  // one flag per instantiation: raise the limit once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_wgmma<MT, NB, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  using T = __nv_bfloat16;
  gmm_wgmma<MT, NB, EPI><<<grid, C::THREADS, C::SMEM, s>>>(
      (const T*)a, b0, b1, n_local, n_rep, tile_group, live_rows, (T*)c, K, N, block_m, act);
  return cudaGetLastError();
}

template <int MT>
int launch_bf16(int gated, int act, const void* x, Bf16 w_in, Bf16 w_gate, Bf16 w_out,
                int n_local, int n_rep, const int* tile_group, const int* live_rows, void* h,
                void* y, int M, int d, int f, int block_m, cudaStream_t s) {
  const dim3 grid_up((f + TN - 1) / TN, M / MT), grid_down((d + TN - 1) / TN, M / MT);
  cudaError_t e =
      gated ? launch_gmm<MT, 2, 2>(grid_up, s, x, w_in, w_gate, n_local, n_rep, tile_group,
                                   live_rows, h, d, f, block_m, act)
            : launch_gmm<MT, 1, 1>(grid_up, s, x, w_in, w_gate, n_local, n_rep, tile_group,
                                   live_rows, h, d, f, block_m, act);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_gmm<MT, 1, 0>(grid_down, s, h, w_out, w_out, n_local, n_rep, tile_group,
                                   live_rows, y, f, d, block_m, act);
}

template <typename T>
Src<T> src(const void* local, const void* rep, const void* extra) {
  return Src<T>{(const T*)local, (const T*)rep, (const T*)extra};
}

}  // namespace

// dtype: 0 float32 (CUDA cores, `live` scratch of M / 32 ints for the
// flag pass), 1 bfloat16 (tensor cores; `live_rows` a device int, or null
// for every tile live).  Each weight comes as its local rows (n_local
// groups), replica rows (n_rep groups; null when n_rep == 0) and foreign
// rows (the groups after them; null when there are none).  Shapes are
// checked by the Python wrapper: M % block_m == 0, d % 64 == 0, f % 64 ==
// 0, block_m % 32 == 0 (f32) or % 64 == 0 (bf16).
extern "C" int moe_gmm_launch(int dtype, int gated, int act, const void* x,
                              const void* w_in, const void* w_gate, const void* w_out,
                              const void* w_in_r, const void* w_gate_r, const void* w_out_r,
                              const void* w_in_x, const void* w_gate_x, const void* w_out_x,
                              int n_local, int n_rep, const int* tile_group, int* live,
                              const int* live_rows, void* h, void* y, int M, int d, int f,
                              int block_m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(gated, act, (const float*)x, src<float>(w_in, w_in_r, w_in_x),
                      src<float>(w_gate, w_gate_r, w_gate_x),
                      src<float>(w_out, w_out_r, w_out_x), n_local, n_rep, tile_group, live,
                      (float*)h, (float*)y, M, d, f, block_m, s);
  const Bf16 wi = src<__nv_bfloat16>(w_in, w_in_r, w_in_x),
             wg = src<__nv_bfloat16>(w_gate, w_gate_r, w_gate_x),
             wo = src<__nv_bfloat16>(w_out, w_out_r, w_out_x);
  if (block_m % 128 == 0)
    return launch_bf16<128>(gated, act, x, wi, wg, wo, n_local, n_rep, tile_group, live_rows,
                            h, y, M, d, f, block_m, s);
  return launch_bf16<64>(gated, act, x, wi, wg, wo, n_local, n_rep, tile_group, live_rows, h,
                         y, M, d, f, block_m, s);
}
