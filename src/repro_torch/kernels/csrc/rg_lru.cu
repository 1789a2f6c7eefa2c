// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/rg_lru.py (rg_lru_scan): for
// every batch row and channel, h_t = a_t * h_{t-1} + b_t over t = 0..S-1
// with an fp32 carry started at h0; it writes every h_t and the last one.
// In the port it takes the place of the JAX model's associative scan in
// every recurrent layer's prefill (models/griffin.py, rg_lru).
//
// What bounds it on an H100: the bytes. It reads a and b and writes h, 12
// bytes per element, plus h0 and h_last; the arithmetic is two operations
// per element. At the main path's prefill shape (B=8, S=3072, D=2560) that
// is 755 MB, 0.225 ms at 3.35 TB/s.
//
// Design: one thread per (batch, channel); the time loop runs inside the
// thread, which takes the place of the TPU kernel's sequential time-chunk
// grid axis (its VMEM tiles and the carry through h_last between grid steps
// have no counterpart here). A warp covers 32 consecutive channels, so each
// step's loads of a and b and the store of h are coalesced 128-byte
// transactions. Each thread loads the next kUnroll steps of a and b into
// registers before it runs the current kUnroll dependent steps, so one
// memory latency is paid per kUnroll steps, not per step. A ragged D is
// masked (threads past D return); there are no padding copies. B x D
// threads (20480 at the main path's shape) leave most of the card's warp
// slots empty: a scan that also splits S over CTAs is later work.
//
// Rounding: h = __fadd_rn(__fmul_rn(a, h), b), a rounded product and then a
// rounded sum, so nvcc cannot contract a*h+b into one FMA. The plain
// version (kernels/ref.py, rg_lru_scan_plain) and the Pallas body round
// twice too, so the kernel equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rg_lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ out,
                   float* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t row = (size_t)blockIdx.y;
  const size_t base = row * (size_t)S * D + d;
  const float* pa = a + base;
  const float* pb = b + base;
  float* po = out + base;
  float h = h0[row * D + d];

  float ca[kUnroll], cb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    ca[u] = u < S ? pa[(size_t)u * D] : 0.f;
    cb[u] = u < S ? pb[(size_t)u * D] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    // start the next chunk's loads before the dependent chain of this one
    float na[kUnroll], nb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + kUnroll + u;
      na[u] = t < S ? pa[(size_t)t * D] : 0.f;
      nb[u] = t < S ? pb[(size_t)t * D] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        po[(size_t)t * D] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_last[row * D + d] = h;
}

}  // namespace

// a, b, out: (B, S, D) fp32 contiguous; h0, h_last: (B, D) fp32 contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rg_lru_scan(const void* a, const void* b, const void* h0,
                           void* out, void* h_last, int B, int S, int D,
                           void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rg_lru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out),
      static_cast<float*>(h_last), S, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward: the reverse-time recurrence of the scan's gradient.
//
// Not a port of a Pallas kernel: the JAX package trains through
// jax.lax.associative_scan, whose gradient jax.grad derives. The port's
// forward is the kernel above, so its gradient is a kernel too. With g_t the
// gradient reaching h_t through every later step:
//
//   g_{S-1} = d_h_all[S-1] + d_h_last
//   g_t     = d_h_all[t] + a_{t+1} * g_{t+1}
//   d_b_t = g_t,   d_a_t = g_t * h_{t-1} (h_{-1} = h0),   d_h0 = a_0 * g_0
//
// A missing gradient (d_h_all or d_h_last a null pointer) counts as zeros
// and is never read.
//
// What bounds it on an H100: the bytes. It reads a, h_all and d_h_all and
// writes d_a and d_b, 20 bytes per element; at the training path's shape
// (B=2, S=1024, D=2560) that is ~105 MB, 0.031 ms at 3.35 TB/s. Design: the
// forward's, run backwards in time: one thread per (batch, channel), a warp
// over 32 consecutive channels so every load and store is a coalesced
// 128-byte transaction, and the next kUnroll steps of a, h and d_h_all
// loaded into registers before the current kUnroll dependent steps run.
// At B=2 only 5120 threads run, so latency is hidden by the unrolled loads
// alone; a scan that splits S over CTAs is later work.
//
// Rounding: one rounded product, then one rounded sum (__fmul_rn /
// __fadd_rn, no FMA), as the plain version (kernels/ref.py,
// rg_lru_scan_bwd_plain) computes it, so the two agree bit for bit.

namespace {

__global__ void __launch_bounds__(kThreads)
rg_lru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ h0,
                       const float* __restrict__ d_h,
                       const float* __restrict__ d_last,
                       float* __restrict__ d_a, float* __restrict__ d_b,
                       float* __restrict__ d_h0, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t row = (size_t)blockIdx.y;
  const size_t base = row * (size_t)S * D + d;
  const float* pa = a + base;
  const float* ph = h + base;
  const float* pd = d_h != nullptr ? d_h + base : nullptr;
  float* pda = d_a + base;
  float* pdb = d_b + base;
  const float hinit = h0[row * D + d];

  // step t's operands: a_t, h_{t-1} (h0 at t = 0) and d_h_all[t]
  auto load = [&](int t, float& va, float& vh, float& vd) {
    va = t >= 0 ? pa[(size_t)t * D] : 0.f;
    vh = t > 0 ? ph[(size_t)(t - 1) * D] : hinit;
    vd = t >= 0 && pd != nullptr ? pd[(size_t)t * D] : 0.f;
  };
  float g = d_last != nullptr ? d_last[row * D + d] : 0.f;
  float a_next = 0.f;                // a_{t+1}
  float ca[kUnroll], ch[kUnroll], cd[kUnroll];
  int t0 = S - kUnroll;              // this chunk: t = t0 .. t0 + kUnroll - 1
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) load(t0 + u, ca[u], ch[u], cd[u]);
  for (; t0 > -kUnroll; t0 -= kUnroll) {
    // start the next (earlier) chunk's loads before this one's chain
    float na[kUnroll], nh[kUnroll], nd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load(t0 - kUnroll + u, na[u], nh[u], nd[u]);
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u) {
      const int t = t0 + u;
      if (t >= 0) {
        if (t < S - 1) g = __fmul_rn(a_next, g);
        if (pd != nullptr) g = __fadd_rn(cd[u], g);
        pdb[(size_t)t * D] = g;
        pda[(size_t)t * D] = __fmul_rn(g, ch[u]);
        a_next = ca[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      ch[u] = nh[u];
      cd[u] = nd[u];
    }
  }
  d_h0[row * D + d] = __fmul_rn(a_next, g);
}

}  // namespace

// a, h, d_h, d_a, d_b: (B, S, D) fp32 contiguous; h0, d_last, d_h0: (B, D)
// fp32 contiguous; d_h and d_last may be null (zeros). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rg_lru_scan_bwd(const void* a, const void* h, const void* h0,
                               const void* d_h, const void* d_last, void* d_a,
                               void* d_b, void* d_h0, int B, int S, int D,
                               void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rg_lru_scan_bwd_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(d_h),
      static_cast<const float*>(d_last), static_cast<float*>(d_a),
      static_cast<float*>(d_b), static_cast<float*>(d_h0), S, D);
  return cudaGetLastError();
}
