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
// microsecond at the memory rate, far below a launch's own latency. So the
// design keeps every step after the launch inside one warp:
//
// * C <= 32 (every main-path shape): a warp per rank row, one CTA of up to
//   32 warps (more CTAs only past 32 rows). The warp counts its row into a
//   warp-private shared histogram (shared atomics, __syncwarp only), lane c
//   reads class c, one shuffle scan gives the exclusive prefix sums, and
//   lanes 0..C-1 store counts and starts. No block-wide barrier.
// * 32 < C <= 12280 (up to the 48 KiB of shared memory a launch takes
//   without opting in): one 256-thread CTA per rank row counts with shared
//   atomics, and each thread scans a contiguous run of classes, a warp
//   shuffle scan and one pass over the warp totals giving each run's start.
//
// Both launch with programmatic dependent launch
// (cudaLaunchAttributeProgrammaticStreamSerialization): each zeroes its
// shared histogram before griddepcontrol.wait (what
// cudaGridDependencySynchronize() runs), so the launch and that prologue
// overlap the tail of the kernel before it. Ids outside [0, C) are skipped,
// never written out of range. Results are exact integers.
//
// empty_kernel (launch_empty) does nothing: its time is the card's launch
// floor, the yardstick for the two launch-bound kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpClasses = 32;     // classes the warp-per-row path takes
constexpr int kRowWarps = 32;        // rows (warps) per CTA on that path
constexpr int kLoads = 8;            // ids a lane loads at once (N = 256)
constexpr int kThreads = 256;        // the CTA-per-row path
constexpr int kWarps = kThreads / 32;
// the dynamic shared counts and the static warp totals share the 48 KiB a
// launch may take without opting in to more
constexpr int kMaxClasses =
    (48 * 1024 - kWarps * (int)sizeof(int32_t)) / (int)sizeof(int32_t);

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(32 * kRowWarps)
histogram_offsets_warp_kernel(const int32_t* __restrict__ ids,
                              int32_t* __restrict__ counts,
                              int32_t* __restrict__ starts, int R, int N,
                              int C) {
  __shared__ int32_t hist_all[kRowWarps][kWarpClasses];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* hist = hist_all[warp];
  hist[lane] = 0;
  grid_dependency_wait();
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;                 // warp-uniform
  __syncwarp();
  const int32_t* row = ids + (size_t)r * N;
  const unsigned c = (unsigned)C;     // ids < 0 wrap above C
  int i = lane;
  for (; i + 32 * (kLoads - 1) < N; i += 32 * kLoads) {
    int32_t v[kLoads];                // all loads in flight before counting
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = row[i + 32 * u];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if ((unsigned)v[u] < c) atomicAdd(&hist[v[u]], 1);
  }
  for (; i < N; i += 32) {
    const int32_t v = row[i];
    if ((unsigned)v < c) atomicAdd(&hist[v], 1);
  }
  __syncwarp();
  const int32_t h = lane < C ? hist[lane] : 0;
  int32_t incl = h;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane < C) {
    counts[(size_t)r * C + lane] = h;
    starts[(size_t)r * C + lane] = incl - h;
  }
}

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
  grid_dependency_wait();
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

__global__ void empty_kernel() {}

template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// ids: (R, N) int32; counts, starts: (R, C) int32. C at most kMaxClasses
// (12280); C <= 32 takes the warp-per-row kernel. Returns the launch's
// error code (0 = launched).
extern "C" int histogram_offsets(const void* ids, void* counts, void* starts,
                                 int R, int N, int C, void* stream) {
  if (R <= 0 || N < 0 || C <= 0 || C > kMaxClasses)
    return cudaErrorInvalidValue;
  const int32_t* in = static_cast<const int32_t*>(ids);
  int32_t* cnt = static_cast<int32_t*>(counts);
  int32_t* st = static_cast<int32_t*>(starts);
  if (C <= kWarpClasses) {
    const int warps = R < kRowWarps ? R : kRowWarps;
    return (int)launch_pdl(histogram_offsets_warp_kernel,
                           dim3((R + warps - 1) / warps), dim3(32 * warps), 0,
                           stream, in, cnt, st, R, N, C);
  }
  return (int)launch_pdl(histogram_offsets_kernel, dim3(R), dim3(kThreads),
                         C * sizeof(int32_t), stream, in, cnt, st, N, C);
}

// One launch of an empty kernel: the card's launch floor.
extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
