// Fused top-k router for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/topk_router.py
// (fused_topk_route, body _kernel): from fp32 router logits, one pass gives
// the softmax probabilities, K rounds of max / argmax (a tie goes to the
// lowest expert index, as lax.top_k breaks it), the un-normalised gates, the
// per-row logsumexp (for the router z-loss) and int32 per-expert counts (the
// Distribution-Only estimator's input and the load-balance loss's f_e).
//
// What bounds it on an H100: the launch. On the main path it reads
// R x T x E fp32 logits (R = 4 ranks x 128 tokens x 8 experts in prefill,
// 8 x 8 in decode) and writes probs of the same size plus K = 2 indices and
// gates per row: tens of KB, nanoseconds at the memory rate.
//
// Design: one warp per row. Each lane holds the row's logits e = lane,
// lane + 32, ... in registers; shuffle reductions give the max and the sum
// for the softmax (exp of (x - max), then division, the Pallas body's
// order), and each of the K rounds is a shuffle arg-max over (value, index)
// pairs that keeps the lower index on equal values, after which the winning
// lane masks its entry to -inf. Rows are grouped by rank: blockIdx.y is the
// rank, so each CTA counts into one shared histogram of its rank's experts
// and flushes it to counts[rank] with one global atomic per expert. The
// wrapper zeroes counts before the launch. expf / logf and IEEE division
// keep fp32 results within a few ulps of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 8;          // E <= 256
constexpr int kMaxK = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
topk_route_kernel(const float* __restrict__ logits, int32_t* __restrict__ idx,
                  float* __restrict__ gates, float* __restrict__ probs,
                  float* __restrict__ lse, int32_t* __restrict__ counts,
                  int T, int E, int K) {
  extern __shared__ int32_t hist[];
  const int r = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < E; e += kThreads) hist[e] = 0;
  __syncthreads();

  const int t = blockIdx.x * kWarps + warp;
  if (t < T) {
    const size_t row = (size_t)r * T + t;
    const float* x = logits + row * E;
    float v[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      v[j] = e < E ? x[e] : -INFINITY;
      m = fmaxf(m, v[j]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      v[j] = e < E ? expf(v[j] - m) : 0.f;
      s += v[j];
    }
    s = warp_sum(s);
    float* p = probs + row * E;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      if (e < E) {
        v[j] = v[j] / s;
        p[e] = v[j];
      } else {
        v[j] = -INFINITY;           // never selected
      }
    }
    if (lane == 0) lse[row] = m + logf(s);

    for (int k = 0; k < K; ++k) {
      // this lane's best: entries are visited in increasing expert index,
      // and only a strictly larger value replaces the best
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        if (v[j] > bv) {
          bv = v[j];
          bi = lane + 32 * j;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        idx[row * K + k] = bi;
        gates[row * K + k] = bv;
        atomicAdd(&hist[bi], 1);
      }
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (lane + 32 * j == bi) v[j] = -INFINITY;
    }
  }
  __syncthreads();
  int32_t* cnt = counts + (size_t)r * E;
  for (int e = threadIdx.x; e < E; e += kThreads)
    if (hist[e]) atomicAdd(&cnt[e], hist[e]);
}

}  // namespace

// logits: (R, T, E) fp32; idx, gates: (R, T, K); probs: (R, T, E);
// lse: (R, T); counts: (R, E) int32, zeroed by the caller. E at most 256,
// 1 <= K <= min(E, 8). Returns cudaGetLastError() after the launch.
extern "C" int fused_topk_route(const void* logits, void* idx, void* gates,
                                void* probs, void* lse, void* counts, int R,
                                int T, int E, int K, void* stream) {
  if (R <= 0 || T <= 0 || E <= 0 || E > 32 * kPerLane || K <= 0 ||
      K > kMaxK || K > E || R > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((T + kWarps - 1) / kWarps, R);
  topk_route_kernel<<<grid, kThreads, E * sizeof(int32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int32_t*>(idx),
      static_cast<float*>(gates), static_cast<float*>(probs),
      static_cast<float*>(lse), static_cast<int32_t*>(counts), T, E, K);
  return cudaGetLastError();
}
