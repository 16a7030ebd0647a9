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
// As on the TPU: masked scores -1e30; running (m, l, acc) in f32; p
// rounded to V's type before P @ V while l sums the unrounded p; out =
// acc / max(l, 1e-30) cast to q's type.  Any S: a ragged last tile is
// masked; causal work stops at the q tile's diagonal, heaviest q tiles
// first.  Two designs, chosen by dtype (no input reaches both):
//
// bf16 (flash_attn_wgmma), the prefill path's type.  What bounds it at
// the prefill shape (B 4, H 16, S 1024, hd 128, causal): bytes and
// operations alike, 67 MB (20.0 us at 3.35 TB/s) and 17.2 GFLOP (17.4 us
// at 989 TFLOP/s), so only the tensor cores can approach it.  Design: a
// block of two consumer warpgroups owns a 128-row q tile of one (batch,
// head), 64 rows each.  Q and a ring of 3 K/V tile pairs (64 positions
// each) are staged in shared memory by 16-byte cp.async copies in the
// 128-byte swizzle (zero-filled past S and past hd), so loading tiles
// j + 1 and j + 2 overlaps the products of tile j.  S = Q K^T is one wgmma
// m64n64k16 per 16 of hd from shared memory (K is K-major); the online
// softmax runs in registers on the accumulator fragments (row max and sum
// over the 4 lanes of a row; interior tiles skip the mask); O += P V is
// wgmma m64n{hd}k16 with P as the register A operand, rounded to bf16
// exactly where the TPU rounds p, and V N-major from shared memory.  hd,
// any multiple of 8 up to 256 (the TPU kernel takes any), is padded to
// HDP = 64, 128 or 256 with zero columns: the copies past hd are
// zero-filled (a 16-byte chunk lies wholly inside hd or past it), so they
// add exact zeros to q k^T and to P V, and no column past hd is stored.
// At HDP 256 the ring holds 2 stages instead of 3 (Q 64 KB and three
// stage pairs of 64 KB would exceed the 227 KB a block can have), and
// P V is two m64n128 products over V's two halves, O being 128 f32
// registers a thread beside the 64 x 64 score tile's 32.  One
// change of arithmetic order: the TPU kernel scales q in f32 before the
// product (flash_attention.py:44); wgmma takes bf16 operands, so the f32
// scores are multiplied by hd^-0.5 instead, which differs only by f32
// rounding.
//
// f32 (flash_attn), for the f32 parity checks: the CUDA-core kernel of
// the first port, its arithmetic unchanged.  One block of 256 threads
// per 64-row q tile walks 64-position kv tiles staged in shared memory as
// f32, each thread a 4 x 4 patch of the score tile and a 4 x
// ceil(hd / 16) accumulator patch (DPT columns compiled: 8 up to hd 128,
// 16 above, one block an SM there: 213,760 bytes of shared memory at hd
// 256); q is scaled in f32 before the product as on the TPU.  wgmma has
// no f32 x f32 form (its f32 route is TF32, ~3 decimal digits).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // kv positions per tile
constexpr int TX = 16;           // threads along a row (kv / hd columns)
constexpr int TY = 16;           // threads along the q rows
constexpr int RPT = BQ / TY;     // q rows per thread (4)
constexpr int CPT = BK / TX;     // kv columns per thread (4)
constexpr float NEG_INF = -1e30f;

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

// Strides are in elements: (batch, position, head); the hd axis is
// contiguous.  DPT: accumulator columns a thread, 8 for hd <= 128, 16 above.
template <int DPT>
__global__ void __launch_bounds__(TX * TY, DPT <= 8 ? 2 : 1)
flash_attn(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk, int H,
           int Hkv, int hd,
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

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + g * ksh;
  const float* vb = v + b * vsb + g * vsh;

  for (int i = tid; i < BQ * hd; i += TX * TY) {
    const int r = i / hd, c = i % hd, row = q0 + r;
    qs[r * hp + c] = row < Sq ? qb[row * qss + c] * scale : 0.f;
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
        kv = kb[p * kss + c];
        vv = vb[p * vss + c];
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
        ps[r * (BK + 1) + tx + TX * j] = p;  // p in V's type, f32
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
        if (tx + TX * j < hd) {
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
    float* o = out + (((size_t)b * Sq + row) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (tx + TX * j < hd) o[tx + TX * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WQ = 128;         // q rows per block: two warpgroups of 64
constexpr int WK = 64;          // kv positions per tile
constexpr int W_THREADS = 256;

// K/V tile pairs in the shared-memory ring: 3, and 2 at HDP 256
template <int HDP>
__host__ __device__ constexpr int w_stages() {
  return HDP == 256 ? 2 : 3;
}
template <int HDP>
constexpr int wgmma_smem_bytes() {  // + alignment slack (197,632 at HDP 256)
  return WQ * HDP * 2 + 2 * w_stages<HDP>() * WK * HDP * 2 + 1024;
}

// HDP: hd padded to 64, 128 or 256.  Strides are in elements: (batch,
// position, head); the hd axis is contiguous and every row starts on 16
// bytes.
template <int HDP>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_attn_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int Sq, int Sk, int H, int Hkv, int hd,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, int causal, float scale) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  constexpr int W_STAGES = w_stages<HDP>();
  constexpr uint32_t Q_BYTES = WQ * HDP * 2, KV_BYTES = WK * HDP * 2;
  constexpr int CPR = HDP / 8;                   // 16-byte chunks per row
  // O as NH accumulators of ON f32 a thread: one m64n{HDP} product, or at
  // HDP 256 two m64n128 over V's column blocks 0-1 and 2-3
  constexpr int NH = HDP > 128 ? HDP / 128 : 1, ON = HDP / NH / 2;
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + Q_BYTES;            // K ring
  const uint32_t s_v = s_k + W_STAGES * KV_BYTES;  // V ring

  const int n_q = (Sq + WQ - 1) / WQ;
  const int t = causal ? n_q - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int q0 = t * WQ;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + g * ksh;
  const __nv_bfloat16* vb = v + b * vsb + g * vsh;
  // causal: kv tiles past the block's last row are never loaded
  const int kv_end = causal ? min(Sk, min(q0 + WQ, Sq)) : Sk;
  const int n_kv = (kv_end + WK - 1) / WK;

  for (int i = tid; i < WQ * CPR; i += W_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, row = q0 + r;
    const bool ok = row < Sq && c < hd;
    cp_async16(s_q + sw128(r, c, WQ), ok ? qb + row * qss + c : qb, ok);
  }
  auto load_kv = [&](int j) {
    const uint32_t st = (j % W_STAGES) * KV_BYTES;
    for (int i = tid; i < WK * CPR; i += W_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, p = j * WK + r;
      const bool ok = p < Sk && c < hd;
      const uint32_t off = st + sw128(r, c, WK);
      cp_async16(s_k + off, ok ? kb + p * kss + c : kb, ok);
      cp_async16(s_v + off, ok ? vb + p * vss + c : vb, ok);
    }
  };
  for (int j = 0; j < W_STAGES - 1; ++j) {       // Q travels with tile 0
    if (j < n_kv) load_kv(j);
    cp_async_commit();
  }

  const int row0 = q0 + wg * 64;                 // this warpgroup's rows
  const int qpos[2] = {row0 + frag_row(wt, 0), row0 + frag_row(wt, 2)};
  float o[NH][ON];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < ON; ++i) o[n][i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  // Per tile: S = Q K^T, the softmax, O += P V, each product waited for in
  // the same tile (a wgmma still in flight when non-wgmma code writes an
  // accumulator makes ptxas serialize every wgmma of the kernel).  A
  // warpgroup whose rows all precede the tile computes it anyway (every
  // score is masked, p is exact zeros) and so does one whose rows lie past
  // Sq (never stored): both warpgroups keep to the same code path.
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<W_STAGES - 2>();               // tile j has landed
    fence_proxy_async();
    __syncthreads();                             // ... for every thread; tile j - 1 consumed
    if (j + W_STAGES - 1 < n_kv) load_kv(j + W_STAGES - 1);
    cp_async_commit();
    const int k0 = j * WK;
    const uint32_t st = (j % W_STAGES) * KV_BYTES;
    // no mask inside the tile: every position exists and is causally visible
    const bool full = k0 + WK <= Sk && (!causal || k0 + WK - 1 <= row0);

    float s[32];                                 // the first product overwrites it
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t qa = s_q + (kk >> 2) * (WQ * 128) + wg * (64 * 128) + (kk & 3) * 32;
      const uint32_t ka = s_k + st + (kk >> 2) * (WK * 128) + (kk & 3) * 32;
      wgmma_ss_n64<0>(s, desc(qa, 16, 1024), desc(ka, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // online softmax on the fragments: this thread holds rows qpos[0..1],
    // 16 kv columns each; a row's other columns live in lanes ^1 and ^2
    float mx[2] = {NEG_INF, NEG_INF};
    if (full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] *= scale;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, kp = k0 + frag_col(wt, i);
        const bool keep = kp < Sk && (!causal || qpos[hh] >= kp);
        s[i] = keep ? s[i] * scale : NEG_INF;
        mx[hh] = fmaxf(mx[hh], s[i]);
      }
    }
    float m_new[2], corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      m_new[hh] = fmaxf(m_run[hh], mx[hh]);
      corr[hh] = expf(m_run[hh] - m_new[hh]);
      m_run[hh] = m_new[hh];
    }
    uint32_t pa[4][4];                           // P as A operand: [k16 step][register]
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hh = (i >> 1) & 1, kp = k0 + frag_col(wt, i);
      // positions past Sk do not exist (the TPU tiles never have them)
      const float p0 = full || kp < Sk ? expf(s[i] - m_new[hh]) : 0.f;
      const float p1 = full || kp + 1 < Sk ? expf(s[i + 1] - m_new[hh]) : 0.f;
      psum[hh] += p0 + p1;
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * corr[hh] + psum[hh];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int i = 0; i < ON; ++i) o[n][i] *= corr[(i >> 1) & 1];

#pragma unroll
    for (int n = 0; n < NH; ++n) reg_fence(o[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        // half n starts at V's column block 2 n (128 columns a half)
        const uint64_t dv =
            desc(s_v + st + kk * (16 * 128) + n * 2 * (WK * 128), WK * 128, 1024);
        if constexpr (ON == 64) wgmma_rs_n128<1>(o[n], pa[kk], dv, 1);
        else wgmma_rs_n64<1>(o[n], pa[kk], dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NH; ++n) reg_fence(o[n]);
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) reg_fence(pa[kk]);
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < ON; i += 2) {
      const int hh = (i >> 1) & 1, row = qpos[hh], col = n * 128 + frag_col(wt, i);
      if (row < Sq && col < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * Sq + row) * H + h) * hd + col) =
            __floats2bfloat162_rn(o[n][i] * inv[hh], o[n][i + 1] * inv[hh]);
    }
}

template <int HDP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                 int Sk, int H, int Hkv, int hd, const long long* st, int causal,
                 float scale, cudaStream_t s) {
  const int bytes = wgmma_smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(flash_attn_wgmma<HDP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + WQ - 1) / WQ, H, B);
  flash_attn_wgmma<HDP><<<grid, W_THREADS, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, Sq, Sk, H, Hkv, hd, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, scale);
  return (int)cudaGetLastError();
}

template <int DPT>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
               int H, int Hkv, int hd, const long long* st, int causal, float scale,
               cudaStream_t s) {
  const size_t bytes = smem_floats(hd) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attn<DPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attn<DPT><<<grid, TX * TY, bytes, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk, H, Hkv, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores).  strides: 9
// element strides, (batch, position, head) of q, k and v.  The Python
// wrapper checks the head-width domain (hd % 8 == 0, 8 <= hd <= 256:
// ops.py `padded_head_dim`), H % Hkv == 0, a contiguous hd axis, Sq == Sk
// when causal, and for bf16 16-byte aligned rows.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq, int Sk,
                                      int H, int Hkv, int hd, const long long* strides,
                                      int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd < 8 || hd % 8 || hd > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return hd <= 128
               ? launch_f32<8>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, strides, causal, scale, s)
               : launch_f32<16>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, strides, causal, scale, s);
  if (hd <= 64)
    return launch_wgmma<64>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, strides, causal, scale, s);
  if (hd <= 128)
    return launch_wgmma<128>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, strides, causal, scale, s);
  return launch_wgmma<256>(q, k, v, out, B, Sq, Sk, H, Hkv, hd, strides, causal, scale, s);
}
