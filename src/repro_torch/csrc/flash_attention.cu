// Flash attention for Hopper (sm_90a): the port of the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (body _kernel; wrapper kernels/flash_attention/ops.py::flash_attention).
//
// What it computes: softmax(q k^T * hd^-0.5) v for q [B, Sq, H, hd] and
// k/v [B, Sk, Hkv, hd], read in the model layout through strides (the last
// axis contiguous), out [B, Sq, H, hd] contiguous.  Causal masking is the
// TPU kernel's, top-left aligned (q_pos >= k_pos; the wrapper asserts
// Sq == Sk when causal, where it equals the reference's bottom-right
// mask).  GQA: q head h reads kv head h / rep, K/V are never repeated.
// Arithmetic order, as on the TPU: q cast to f32 and multiplied by the
// scale before the product with k in f32; masked scores -1e30; running
// (m, l, acc) in f32; p rounded to V's type before P @ V while l sums the
// unrounded p; out = acc / max(l, 1e-30) cast to q's type.
//
// What bounds it: at the prefill shapes (B 4, H 16, S 1024, hd 128, bf16)
// the operations (17.2 GFLOP causal) and the bytes (67 MB) give about the
// same least time on the card (~20 us).  This first version computes on
// the CUDA cores in f32, so it is bound by the shared-memory reads of its
// inner products, far above that.
// What the design does about it: the TPU's 512 x 512 tiles and [512, hd]
// f32 accumulator (256 KB at hd 128) exceed a block's shared memory, so one
// block of 256 threads takes a 64-row q tile of one (batch, head) and
// walks 64-position kv tiles staged in shared memory, stopping at the
// tile's diagonal (the kv grid axis of the TPU becomes this loop; no state
// crosses blocks).  Each thread owns a 4 x 4 patch of the 64 x 64 score
// tile and a 4 x (hd / 16) patch of the accumulator; row maxima and sums
// are reduced over the 16 lanes that share a row.  Padded rows keep shared
// reads free of bank conflicts.  A ragged last tile (any Sq, Sk) is masked.
// The heaviest q tiles (the last under a causal mask) are launched first.
// Tensor cores (wgmma) and TMA are left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // kv positions per tile
constexpr int TX = 16;           // threads along a row (kv / hd columns)
constexpr int TY = 16;           // threads along the q rows
constexpr int RPT = BQ / TY;     // q rows per thread (4)
constexpr int CPT = BK / TX;     // kv columns per thread (4)
constexpr int HD_MAX = 128;
constexpr int DPT = HD_MAX / TX; // accumulator columns per thread, at most 8
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// max / sum over the 16 lanes of one half-warp (the threads of one q row)
__device__ __forceinline__ float row_max(float v) {
  for (int o = TX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr size_t smem_floats(int hd) {
  return (size_t)BQ * (hd + 1) + (size_t)BK * (hd + 1) + (size_t)BK * hd
         + (size_t)BQ * (BK + 1);
}

// Strides are in elements: (batch, position, head); the hd axis is contiguous.
template <typename T>
__global__ void __launch_bounds__(TX * TY, 2)
flash_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int Sq, int Sk, int H, int Hkv, int hd,
           long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, int causal, float scale) {
  extern __shared__ float smem[];
  const int hp = hd + 1;
  float* qs = smem;                          // [BQ][hd + 1]
  float* ks = qs + BQ * hp;                  // [BK][hd + 1]
  float* vs = ks + BK * hp;                  // [BK][hd]
  float* ps = vs + BK * hd;                  // [BQ][BK + 1]

  const int n_q = (Sq + BQ - 1) / BQ;
  const int t = causal ? n_q - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int q0 = t * BQ;
  const int nj = hd / TX;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + g * ksh;
  const T* vb = v + b * vsb + g * vsh;

  for (int i = tid; i < BQ * hd; i += TX * TY) {
    const int r = i / hd, c = i % hd, row = q0 + r;
    qs[r * hp + c] = row < Sq ? to_f(qb[row * qss + c]) * scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // causal: kv tiles past the tile's last row are never loaded
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, last_row + 1) : Sk;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // q written; the previous tile's K, V and P consumed
    for (int i = tid; i < BK * hd; i += TX * TY) {
      const int r = i / hd, c = i % hd, p = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (p < Sk) {
        kv = to_f(kb[p * kss + c]);
        vv = to_f(vb[p * vss + c]);
      }
      ks[r * hp + c] = kv;
      vs[r * hd + c] = vv;
    }
    __syncthreads();

    // scores of rows ty*RPT + i, kv columns tx + TX*j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < hd; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * hp + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + TX * j) * hp + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i, q_pos = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int k_pos = k0 + tx + TX * j;
        const bool keep = k_pos < Sk && (!causal || q_pos >= k_pos);
        s[i][j] = keep ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int k_pos = k0 + tx + TX * j;
        // positions past Sk do not exist (the TPU tiles never have them)
        const float p = k_pos < Sk ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[r * (BK + 1) + tx + TX * j] = to_f(from_f<T>(p));  // p in V's type
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int kn = min(BK, Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty * RPT + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        if (j < nj) {
          const float vv = vs[kk * hd + tx + TX * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + row) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (j < nj) o[tx + TX * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int Hkv, int hd, const long long* st, int causal, float scale,
           cudaStream_t s) {
  const size_t bytes = smem_floats(hd) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attn<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attn<T><<<grid, TX * TY, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, Hkv, hd, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 9 element strides, (batch,
// position, head) of q, k and v.  The Python wrapper checks hd % 16 == 0,
// hd <= 128, H % Hkv == 0, a contiguous hd axis, and Sq == Sk when causal.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq, int Sk,
                                      int H, int Hkv, int hd, const long long* strides,
                                      int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, strides, causal, scale, s);
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, strides, causal,
                               scale, s);
}
