// Class histogram and its exclusive prefix sum for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/histogram.py (histogram_offsets:
// the Pallas histogram, then the cumsum that JAX runs outside Pallas). The
// sort-based EP packer reads the pair as each slot's fill level and the start
// of its run in the argsorted (token, k) order.
//
// What bounds it on an H100: nothing but the launch. On the main path a
// launch reads R x N int32 ids (R = 4 EP ranks; N = 256 in prefill, 16 in
// decode) and writes 2 x R x C int32 (C = 13 or 4 classes): about 4 KB, a
// microsecond at the memory rate, far below a launch's own latency.
//
// Design: one CTA per rank row, so one launch covers all R ranks. The CTA
// counts its ids with shared-memory atomics (ids outside [0, C) are skipped,
// never written out of range), then scans the C counts in the same CTA: each
// thread sums a contiguous run of classes, a warp-shuffle scan and one pass
// over the warp totals give each run's start, and each thread writes its
// classes' counts and starts. Results are exact integers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the dynamic shared counts and the static warp totals share the 48 KiB a
// launch may take without opting in to more
constexpr int kMaxClasses =
    (48 * 1024 - kWarps * (int)sizeof(int32_t)) / (int)sizeof(int32_t);

__global__ void __launch_bounds__(kThreads)
histogram_offsets_kernel(const int32_t* __restrict__ ids,
                         int32_t* __restrict__ counts,
                         int32_t* __restrict__ starts, int N, int C) {
  extern __shared__ int32_t hist[];
  __shared__ int32_t warp_total[kWarps];
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* row = ids + (size_t)r * N;
  for (int c = tid; c < C; c += kThreads) hist[c] = 0;
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) {
    const int32_t v = row[i];
    if (v >= 0 && v < C) atomicAdd(&hist[v], 1);
  }
  __syncthreads();

  // exclusive scan: thread tid owns classes [c0, c1)
  const int per = (C + kThreads - 1) / kThreads;
  const int c0 = min(C, tid * per), c1 = min(C, c0 + per);
  int32_t local = 0;
  for (int c = c0; c < c1; ++c) local += hist[c];
  int32_t incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int32_t run = incl - local;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  int32_t* cnt = counts + (size_t)r * C;
  int32_t* st = starts + (size_t)r * C;
  for (int c = c0; c < c1; ++c) {
    const int32_t h = hist[c];
    cnt[c] = h;
    st[c] = run;
    run += h;
  }
}

}  // namespace

// ids: (R, N) int32; counts, starts: (R, C) int32. C at most kMaxClasses
// (12280).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int histogram_offsets(const void* ids, void* counts, void* starts,
                                 int R, int N, int C, void* stream) {
  if (R <= 0 || N < 0 || C <= 0 || C > kMaxClasses)
    return cudaErrorInvalidValue;
  histogram_offsets_kernel<<<R, kThreads, C * sizeof(int32_t),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(starts), N, C);
  return cudaGetLastError();
}
