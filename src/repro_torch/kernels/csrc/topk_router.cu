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
// 1 x 8 x 8 in decode) and writes probs of the same size plus K = 2 indices
// and gates per row: tens of KB, nanoseconds at the memory rate, against a
// few microseconds for any launch. So the design spends nothing beside the
// one launch:
//
// * No memset of counts before it. Each rank's rows run in one thread-block
//   cluster (at most the portable 8 CTAs, grid (C, R), cluster (C, 1, 1)).
//   Each CTA counts its rows' picks into its own shared histogram. With one
//   CTA per rank (up to 2 x 32 warp passes: every main-path shape) the CTA
//   stores its E counts after a __syncthreads; with more, after a cluster
//   barrier the cluster's first CTA sums the C histograms through
//   distributed shared memory and stores them, and a second (relaxed)
//   barrier keeps every CTA resident until its histogram has been read. No
//   global atomics, so nothing has to be zeroed first. One CTA takes a
//   rank whenever it can: at the main path's shapes the cluster barriers
//   cost more device time than the extra CTAs save.
// * Rows packed into warps for small E. For E <= 16 a row takes a segment
//   of SEG lanes (E rounded up to a power of two), so a warp routes 32 / SEG
//   rows at once (4 rows for Mixtral's 8 experts) and the max, sum and
//   arg-max shuffles run within the segment (the width argument of
//   __shfl_xor_sync). For 16 < E <= 256 a warp takes one row and each lane
//   holds experts lane, lane + 32, ... in PER registers. A warp that has
//   more rows than the cluster has warps loops over them.
// * Programmatic dependent launch: the launch carries
//   cudaLaunchAttributeProgrammaticStreamSerialization, and the kernel
//   zeroes its shared histogram before griddepcontrol.wait (what
//   cudaGridDependencySynchronize() runs), so its launch and prologue
//   overlap the tail of the kernel before it (the logits' matmul).
//
// Arithmetic per row follows the Pallas body: exp of (x - max), a sum, a
// division; each top-k round keeps the larger value and, on equal values,
// the lower index, in every lane and every shuffle step. expf / logf and
// IEEE division keep fp32 results within a few ulps of the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxExperts = 256;
constexpr int kMaxK = 8;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxWarps = 32;        // warps per CTA

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <int SEG>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, SEG));
  return v;
}

template <int SEG>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, SEG);
  return v;
}

// SEG lanes per row (1..32, a power of two); each lane holds PER experts
// (PER > 1 only with SEG = 32).
template <int SEG, int PER>
__global__ void __launch_bounds__(32 * kMaxWarps)
topk_route_kernel(const float* __restrict__ logits, int32_t* __restrict__ idx,
                  float* __restrict__ gates, float* __restrict__ probs,
                  float* __restrict__ lse, int32_t* __restrict__ counts,
                  int T, int E, int K) {
  extern __shared__ int32_t hist[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int e = threadIdx.x; e < E; e += blockDim.x) hist[e] = 0;
  __syncthreads();
  grid_dependency_wait();

  constexpr int kRows = 32 / SEG;    // rows a warp routes at once
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int sl = lane & (SEG - 1), seg = lane / SEG;
  const int warps = blockDim.x >> 5;
  const int gwarp = (int)cluster.block_rank() * warps + (threadIdx.x >> 5);
  const int stride = (int)cluster.num_blocks() * warps * kRows;
  for (int t0 = gwarp * kRows; t0 < T; t0 += stride) {   // warp-uniform
    const int t = t0 + seg;
    const bool live = t < T;
    const size_t row = (size_t)r * T + (live ? t : 0);
    const float* x = logits + row * E;
    float v[PER];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = sl + SEG * j;
      v[j] = live && e < E ? x[e] : -INFINITY;
      m = fmaxf(m, v[j]);
    }
    m = seg_max<SEG>(m);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = sl + SEG * j;
      v[j] = e < E ? expf(v[j] - m) : 0.f;
      s += v[j];
    }
    s = seg_sum<SEG>(s);
    float* p = probs + row * E;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = sl + SEG * j;
      if (e < E) {
        v[j] = v[j] / s;
        if (live) p[e] = v[j];
      } else {
        v[j] = -INFINITY;           // never selected
      }
    }
    if (live && sl == 0) lse[row] = m + logf(s);

    for (int k = 0; k < K; ++k) {
      // this lane's best: entries are visited in increasing expert index,
      // and only a strictly larger value replaces the best
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (v[j] > bv) {
          bv = v[j];
          bi = sl + SEG * j;
        }
      }
#pragma unroll
      for (int o = SEG / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o, SEG);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o, SEG);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (live && sl == 0) {
        idx[row * K + k] = bi;
        gates[row * K + k] = bv;
        atomicAdd(&hist[bi], 1);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (sl + SEG * j == bi) v[j] = -INFINITY;
    }
  }

  if (cluster.num_blocks() == 1) {  // one CTA holds the rank's counts
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      counts[(size_t)r * E + e] = hist[e];
    return;
  }
  // the cluster's first CTA sums every CTA's histogram into counts[r]
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int n = (int)cluster.num_blocks();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      int32_t c = 0;
      for (int b = 0; b < n; ++b) c += cluster.map_shared_rank(hist, b)[e];
      counts[(size_t)r * E + e] = c;
    }
  }
  // keep each histogram until it was read; the first CTA's reads have
  // returned before it arrives (their sums were stored), so the arrive
  // needs no release and does not wait for this CTA's global stores
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

template <int SEG, int PER>
cudaError_t launch(const void* logits, void* idx, void* gates, void* probs,
                   void* lse, void* counts, int R, int T, int E, int K,
                   void* stream) {
  // a warp pass routes 32 / SEG rows. Up to two passes per warp, one CTA
  // of up to 32 warps takes the rank (no cluster barrier); past that the
  // passes spread over a cluster of up to 8 such CTAs, looping when there
  // are more
  const int passes = (T + 32 / SEG - 1) / (32 / SEG);
  const int ctas = passes <= 2 * kMaxWarps
                       ? 1
                       : std::min(kMaxCluster,
                                  (passes + kMaxWarps - 1) / kMaxWarps);
  const int warps = std::min(kMaxWarps, (passes + ctas - 1) / ctas);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, R, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = E * sizeof(int32_t);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ctas;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, topk_route_kernel<SEG, PER>, static_cast<const float*>(logits),
      static_cast<int32_t*>(idx), static_cast<float*>(gates),
      static_cast<float*>(probs), static_cast<float*>(lse),
      static_cast<int32_t*>(counts), T, E, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// logits: (R, T, E) fp32; idx, gates: (R, T, K); probs: (R, T, E);
// lse: (R, T); counts: (R, E) int32, written whole (no zeroing needed).
// E at most 256, 1 <= K <= min(E, 8), R at most 65535. Returns the launch's
// error code (0 = launched).
extern "C" int fused_topk_route(const void* logits, void* idx, void* gates,
                                void* probs, void* lse, void* counts, int R,
                                int T, int E, int K, void* stream) {
  if (R <= 0 || T <= 0 || E <= 0 || E > kMaxExperts || K <= 0 ||
      K > kMaxK || K > E || R > 65535)
    return cudaErrorInvalidValue;
  using Launch = cudaError_t (*)(const void*, void*, void*, void*, void*,
                                 void*, int, int, int, int, void*);
  const Launch f = E <= 1     ? &launch<1, 1>
                   : E <= 2   ? &launch<2, 1>
                   : E <= 4   ? &launch<4, 1>
                   : E <= 8   ? &launch<8, 1>
                   : E <= 16  ? &launch<16, 1>
                   : E <= 32  ? &launch<32, 1>
                   : E <= 64  ? &launch<32, 2>
                   : E <= 128 ? &launch<32, 4>
                              : &launch<32, 8>;
  return (int)f(logits, idx, gates, probs, lse, counts, R, T, E, K, stream);
}

// ---------------------------------------------------------------------------
// The backward: d_logits of the router's differentiable outputs.
//
// Not a port of a Pallas kernel: the JAX package trains through the dense
// route (jax.grad of softmax, top_k and logsumexp). This is that gradient,
// written by hand because the port's forward is the kernel above. The gates
// are the probs at the chosen indices and d lse / d logits = probs, so per
// row (E experts, K picks):
//
//   dp_e       = d_probs_e + d_gates_k          (e = idx_k; else d_probs_e)
//   d_logits_e = p_e * (dp_e - sum_j p_j dp_j) + p_e * d_lse
//
// A missing gradient (a null pointer) counts as zeros and is never read.
//
// What bounds it on an H100: the bytes, a few dozen per row (probs, d_probs
// and d_logits of E fp32 each, K indices and gates, one d_lse); on the
// training path (1, 2048, 8) with K 2 that is ~215 KB, 0.06 us at the memory
// rate, so the launch bounds it in practice. Design: the forward's layout.
// For E <= 32 a row takes a segment of SEG lanes (E rounded up to a power of
// two), 32 / SEG rows per warp, so a warp's loads of probs, d_probs and its
// store of d_logits are one contiguous run; for 32 < E <= 256 a warp takes
// one row and each lane holds experts lane, lane + 32, ... in PER registers
// (each of the PER loads and stores one contiguous run of 32 lanes). The
// sum over E is a lane's own partial sum, then a segment shuffle. Warps
// stride over the rows. Every product, difference and sum rounds once
// (__fmul_rn / __fsub_rn / __fadd_rn, no contraction into FMA), in the order
// of the plain version (kernels/ref.py, fused_topk_route_bwd_plain); only the
// order of the sum over E differs from it.

namespace {

constexpr int kBwdThreads = 256;

template <int SEG, int PER>
__global__ void __launch_bounds__(kBwdThreads)
topk_route_bwd_kernel(const float* __restrict__ probs,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ d_gates,
                      const float* __restrict__ d_probs,
                      const float* __restrict__ d_lse,
                      float* __restrict__ d_logits, int64_t rows, int E,
                      int K) {
  constexpr int kRows = 32 / SEG;
  const int lane = threadIdx.x & 31;
  const int sl = lane & (SEG - 1), seg = lane / SEG;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r0 = warp * kRows; r0 < rows; r0 += warps * kRows) {  // warp-uniform
    const int64_t row = r0 + seg;
    const bool row_live = row < rows;
    const size_t base = (size_t)(row_live ? row : 0) * E;
    float p[PER], dp[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = sl + SEG * j;
      const bool live = row_live && e < E;
      p[j] = live ? probs[base + e] : 0.f;
      dp[j] = live && d_probs != nullptr ? d_probs[base + e] : 0.f;
    }
    if (d_gates != nullptr && row_live) {
      for (int k = 0; k < K; ++k) {
        const int i = idx[row * K + k];
#pragma unroll
        for (int j = 0; j < PER; ++j)
          if (sl + SEG * j == i && i < E)
            dp[j] = __fadd_rn(dp[j], d_gates[row * K + k]);
      }
    }
    float s = __fmul_rn(p[0], dp[0]);
#pragma unroll
    for (int j = 1; j < PER; ++j) s = __fadd_rn(s, __fmul_rn(p[j], dp[j]));
#pragma unroll
    for (int o = SEG / 2; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o, SEG));
    const float dl = d_lse != nullptr && row_live ? d_lse[row] : 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = sl + SEG * j;
      float d = __fmul_rn(p[j], __fsub_rn(dp[j], s));
      if (d_lse != nullptr) d = __fadd_rn(d, __fmul_rn(p[j], dl));
      if (row_live && e < E) d_logits[base + e] = d;
    }
  }
}

template <int SEG, int PER>
cudaError_t launch_bwd(const void* probs, const void* idx, const void* d_gates,
                       const void* d_probs, const void* d_lse, void* d_logits,
                       int64_t rows, int E, int K, void* stream) {
  constexpr int kRowsPerCta = (kBwdThreads / 32) * (32 / SEG);
  const int64_t ctas = std::min<int64_t>((rows + kRowsPerCta - 1) / kRowsPerCta,
                                         132 * 16);
  topk_route_bwd_kernel<SEG, PER><<<(unsigned)ctas, kBwdThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const int32_t*>(idx),
      static_cast<const float*>(d_gates), static_cast<const float*>(d_probs),
      static_cast<const float*>(d_lse), static_cast<float*>(d_logits), rows,
      E, K);
  return cudaGetLastError();
}

}  // namespace

// probs, d_probs, d_logits: (rows, E) fp32; idx, d_gates: (rows, K) int32 /
// fp32; d_lse: (rows,) fp32; d_gates, d_probs and d_lse may be null (zeros).
// E at most 256 (the forward's kMaxExperts), 1 <= K <= min(E, 8). Returns
// the launch's error code.
extern "C" int fused_topk_route_bwd(const void* probs, const void* idx,
                                    const void* d_gates, const void* d_probs,
                                    const void* d_lse, void* d_logits,
                                    int64_t rows, int E, int K, void* stream) {
  if (rows <= 0 || E <= 0 || E > kMaxExperts || K <= 0 || K > kMaxK ||
      K > E)
    return cudaErrorInvalidValue;
  using Launch = cudaError_t (*)(const void*, const void*, const void*,
                                 const void*, const void*, void*, int64_t, int,
                                 int, void*);
  const Launch f = E <= 1     ? &launch_bwd<1, 1>
                   : E <= 2   ? &launch_bwd<2, 1>
                   : E <= 4   ? &launch_bwd<4, 1>
                   : E <= 8   ? &launch_bwd<8, 1>
                   : E <= 16  ? &launch_bwd<16, 1>
                   : E <= 32  ? &launch_bwd<32, 1>
                   : E <= 64  ? &launch_bwd<32, 2>
                   : E <= 128 ? &launch_bwd<32, 4>
                              : &launch_bwd<32, 8>;
  return (int)f(probs, idx, d_gates, d_probs, d_lse, d_logits, rows, E, K,
                stream);
}
