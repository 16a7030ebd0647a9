// HarMoEny's greedy token rebalancing (paper Alg. 2) in one CTA.
//
// Replaces the JAX scheduler's `lax.while_loop` (src/repro/core/scheduler.py
// `rebalance`, the loop at :205), which runs inside the jitted step; it is
// not a Pallas kernel.  The port's plain version is
// `kernels/schedule/ops.py::rebalance_plain` (numpy), and this kernel must
// equal it integer for integer: S and the four diagnostics.
//
// What bounds it: latency.  It reads and writes a schedule of a few kB
// (S [G, Ep, G] int32: 4 x 60 x 4 x 4 bytes = 3.8 kB for qwen15-moe-a27b
// at G = 4) and makes a chain of dependent scalar decisions, at most
// max_iters of them.  The design keeps everything in shared memory and
// keeps the loop short:
//   * all threads load S and sum the per-destination loads t_g [G] and the
//     pair loads pair [G_src, G_dst] once (shared-memory atomics on ints:
//     the order does not change an integer sum);
//   * warp 0 runs the loop.  Every lane takes the same decisions from the
//     same shared state, so no value has to be broadcast; the argmax over
//     an expert column (Ep entries) and over the pair matrix (G x G) are
//     warp reductions that keep the first index on ties, as numpy and
//     jnp do;
//   * a move changes two entries of S, so lane 0 updates t_g, pair and
//     the foreign-slot counts in place instead of summing S again.
// Stop conditions, in the plain version's order: the loop condition (no
// destination above t_avg and no pair over c_pair), then stop_q,
// none_allowed, g_min == g_hot, t_s <= 0, stop_cap; `iters` counts the
// deciding iteration.  int32 arithmetic throughout, as JAX's.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// (value, index) with the larger value, or the smaller index on ties.
__device__ __forceinline__ void argmax_warp(int& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void rebalance_kernel(const int* __restrict__ S_in,
                                 const int* __restrict__ is_local_in, int* __restrict__ S_out,
                                 int* __restrict__ diag, int G, int Ep, int q, int c_pair,
                                 int num_foreign_slots, int max_iters) {
  extern __shared__ int smem[];
  const int n = G * Ep * G;
  int* S = smem;                              // [G, Ep, G]
  int* t_g = S + n;                           // [G]
  int* pair = t_g + G;                        // [G, G]
  int* n_foreign = pair + G * G;              // [G]
  unsigned char* local = reinterpret_cast<unsigned char*>(n_foreign + G);  // [G, Ep]
  unsigned char* foreign = local + G * Ep;                                   // [G, Ep]
  const int tid = threadIdx.x;

  for (int i = tid; i < G + G * G + G; i += blockDim.x) t_g[i] = 0;  // t_g, pair, n_foreign
  for (int i = tid; i < G * Ep; i += blockDim.x) {
    local[i] = is_local_in[i] != 0;
    foreign[i] = 0;
  }
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const int v = S_in[i];
    S[i] = v;
    const int g_to = i % G, g_from = i / (Ep * G);
    if (v) {
      atomicAdd(&t_g[g_to], v);
      atomicAdd(&pair[g_from * G + g_to], v);
    }
  }
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    int total = 0, before = INT_MIN;
    for (int g = 0; g < G; ++g) {
      total += t_g[g];
      before = max(before, t_g[g]);
    }
    const int t_avg = total / G;              // line 4 (loads are >= 0)
    int it = 0, moved = 0;
    while (it < max_iters) {
      // line 6: any destination over t_avg, or an off-diagonal pair over c_pair
      int any_over = 0;
      for (int g = 0; g < G; ++g) any_over |= t_g[g] > t_avg;
      int best = INT_MIN, flat = INT_MAX;     // argmax of over_pair, first index
      for (int i = lane; i < G * G; i += 32) {
        const int v = (i / G == i % G ? 0 : pair[i]) - c_pair;
        if (v > best) {
          best = v;
          flat = i;
        }
      }
      argmax_warp(best, flat);
      const bool has_pair_over = best > 0;
      if (!(any_over || has_pair_over)) break;
      ++it;
      int g_from, g_hot;
      if (has_pair_over) {
        g_from = flat / G;
        g_hot = flat % G;
      } else {
        g_hot = 0;                            // line 7
        for (int g = 1; g < G; ++g)
          if (t_g[g] > t_g[g_hot]) g_hot = g;
        g_from = 0;                           // line 8
        for (int g = 1; g < G; ++g)
          if (pair[g * G + g_hot] > pair[g_from * G + g_hot]) g_from = g;
      }
      // line 9: the expert of the largest chunk (g_from, :, g_hot)
      int t_move = INT_MIN, e_max = INT_MAX;
      const int* col = S + g_from * Ep * G + g_hot;
      for (int e = lane; e < Ep; e += 32) {
        const int v = col[e * G];
        if (v > t_move) {
          t_move = v;
          e_max = e;
        }
      }
      argmax_warp(t_move, e_max);             // line 11
      const bool stop_q = !has_pair_over && t_move < q;  // line 12
      // line 15: the least-loaded allowed destination, first index
      int g_min = 0, min_load = INT_MAX;
      bool any_allowed = false;
      for (int g = 0; g < G; ++g) {
        const bool slot_ok = local[g * Ep + e_max] || foreign[g * Ep + e_max] ||
                             n_foreign[g] < num_foreign_slots;
        const int slack = g == g_from ? INT_MAX : c_pair - pair[g_from * G + g];
        const bool allowed = slot_ok && slack > 0 && g != g_hot;
        any_allowed |= allowed;
        const int load = allowed ? t_g[g] : INT_MAX;
        if (load < min_load) {
          min_load = load;
          g_min = g;
        }
      }
      const int slack_min = g_min == g_from ? INT_MAX : c_pair - pair[g_from * G + g_min];
      const int headroom = t_avg - t_g[g_min] + (has_pair_over ? q : 0);
      int t_s = min(t_move, min(headroom, slack_min));
      if (has_pair_over) t_s = min(t_s, max(best, 0));  // shed only the overflow
      const bool stop_cap = !has_pair_over && (t_g[g_min] + q > t_avg);  // line 16
      if (stop_q || !any_allowed || g_min == g_hot || t_s <= 0 || stop_cap) break;
      __syncwarp();
      if (lane == 0) {                        // lines 20-23
        S[(g_from * Ep + e_max) * G + g_hot] -= t_s;
        S[(g_from * Ep + e_max) * G + g_min] += t_s;
        t_g[g_hot] -= t_s;
        t_g[g_min] += t_s;
        pair[g_from * G + g_hot] -= t_s;
        pair[g_from * G + g_min] += t_s;
        const int f = g_min * Ep + e_max;
        if (!local[f] && !foreign[f]) {
          foreign[f] = 1;
          ++n_foreign[g_min];
        }
      }
      __syncwarp();
      moved += t_s;
    }
    if (lane == 0) {
      int after = INT_MIN;
      for (int g = 0; g < G; ++g) after = max(after, t_g[g]);
      diag[0] = it;
      diag[1] = moved;
      diag[2] = before;
      diag[3] = after;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) S_out[i] = S[i];
}

}  // namespace

// Shared memory of one call: S, t_g, pair, the foreign-slot counts, and
// the local and foreign flags.  The wrapper refuses shapes above 48 kB.
extern "C" int schedule_smem_bytes(int G, int Ep) {
  return (G * Ep * G + G + G * G + G) * 4 + 2 * G * Ep;
}

// S_in, S_out [G, Ep, G] int32; is_local [G, Ep] int32 (0 / 1); diag [4]
// int32 = (iters, moved, max_load_before, max_load_after).  One CTA.
extern "C" int schedule_rebalance_launch(const int* S_in, const int* is_local, int* S_out,
                                         int* diag, int G, int Ep, int q, int c_pair,
                                         int num_foreign_slots, int max_iters, void* stream) {
  const int smem = schedule_smem_bytes(G, Ep);
  if (G < 1 || Ep < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  rebalance_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(
      S_in, is_local, S_out, diag, G, Ep, q, c_pair, num_foreign_slots, max_iters);
  return (int)cudaGetLastError();
}
