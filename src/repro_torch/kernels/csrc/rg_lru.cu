// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface:
// the forward and its reverse-time backward on one skeleton.
//
// The forward replaces the TPU kernel src/repro/kernels/rg_lru.py
// (rg_lru_scan): for every batch row and channel, h_t = a_t * h_{t-1} + b_t
// over t = 0..S-1 with an fp32 carry started at h0; it writes every h_t and
// the last one. In the port it takes the place of the JAX model's associative
// scan in every recurrent layer's prefill and train forward
// (models/griffin.py, rg_lru). The backward (below) is its gradient.
//
// What bounds both on an H100: the bytes. The forward reads a and b and
// writes h, 12 bytes per element; the backward reads a, h_all and d_h_all
// and writes d_a and d_b, 20 bytes. The arithmetic is two or three operations
// per element. At Griffin's prefill shape (B=8, S=3072, D=2560) the forward's
// bytes take 0.225 ms at 3.35 TB/s, at the training shape (B=2, S=1024,
// D=2560) the forward's 0.019 ms and the backward's 0.031 ms.
//
// Why the first design fell short: one thread per (batch, channel) loaded
// its next 16 steps into registers before running the current 16, so a thread
// had 16 x 2 x 4 = 128 bytes in flight (192 in the backward). Streaming at
// 3.35 TB/s over a loaded memory latency of about 0.7 us takes about 2.3 MB
// in flight (Little's law). At the prefill shape 20480 threads kept 2.6 MB
// (3.9 MB backward) and ran at 0.70-0.81 of the bound; at the training shape
// 5120 threads kept 0.66 MB (1.0 MB), and the backward ran at 0.34.
//
// The design: a CTA owns a strip of kStrip consecutive channels of one batch
// row, one thread per channel. Time is cut into tiles of kTile steps, and a
// ring of stages in shared memory holds the strip's next tiles of every
// input while the threads run the chain on the oldest one. Where D % 4 == 0
// and the inputs are 16-byte aligned, one thread fills a stage with a TMA box
// per input (a 3-D map over (D, S, B); rows past S and channels past D come
// back as zeros) and arms the stage's mbarrier; otherwise every thread copies
// 4-byte elements with cp.async (a template of the same kernel, never the
// plain version). Bytes in flight, the ring less the stage being read:
//   forward  (4 stages x 16 KB): 48 KB a CTA
//   backward (3 stages x 24 KB): 48 KB a CTA
// At the training shape 2 x 40 = 80 CTAs keep 3.9 MB in flight; at the
// prefill shape 320 CTAs, all resident at three a SM, keep 15.7 MB. A strip of
// 64 channels reads whole 256-byte row segments; narrower strips (more CTAs,
// shorter segments) and deeper rings measured slower on the card. Each thread
// stores its outputs straight to device memory: a strip row per step is a
// coalesced 256-byte store. h_last / d_h0 are written once at the end.
//
// Why S is not split over CTAs: a chunked scan combines carries (h = h_local
// + prod(a) * carry), which rounds in another order than the loop, and the
// kernels must equal their plain versions (kernels/ref.py) bit for bit. The
// parallelism comes from the channels; the ring covers the latency. The TPU
// kernel's sequential time-chunk grid axis and its carry through h_last
// between grid steps become the loop over tiles inside the CTA.
//
// Rounding: h = __fadd_rn(__fmul_rn(a, h), b), a rounded product and then a
// rounded sum, so nvcc cannot contract a*h+b into one FMA. The plain version
// (rg_lru_scan_plain) and the Pallas body round twice too.

#include "hopper.cuh"

namespace {

constexpr int kStrip = 64;              // channels a CTA, one thread each
constexpr int kTile = 32;               // timesteps a ring stage
constexpr int kTileFloats = kTile * kStrip;
constexpr int kFwdStages = 4;           // a, b:            4 x 16 KB
constexpr int kBwdStages = 3;           // a, h_{t-1}, d_h: 3 x 24 KB

// The ring of kStages stages of kInputs tiles, then one mbarrier a stage.
template <int kInputs, int kStages>
constexpr size_t ring_bytes() {
  return sizeof(float) * kStages * kInputs * kTileFloats +
         sizeof(uint64_t) * kStages;
}

// TMA maps of the (B, S, D) inputs, innermost first; a kernel parameter
struct Maps {
  CUtensorMap m[3];
};

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The 4-byte path: starts the copies of tile rows [r0, r1) of the strip
// (channels past D skipped) into dst, row r at dst + r * kStrip; row_ptr(r)
// is the device row that tile row r holds.
template <typename RowPtr>
__device__ __forceinline__ void copy_tile(float* dst, RowPtr row_ptr, int r0,
                                          int r1, int c0, int D) {
  const int c = threadIdx.x;
  if (c0 + c >= D) return;
  for (int r = r0; r < r1; ++r) copy_async4(dst + r * kStrip + c, row_ptr(r) + c0 + c);
}

// The skeleton both kernels run: tile i is loaded into stage i % kStages
// kStages - 1 tiles ahead of the chain. load(i, s) starts tile i's loads into
// stage s (on the TMA path thread 0 arms full[s] and issues the boxes; on the
// 4-byte path every thread copies its channel and one cp.async group follows);
// chain(i, s) runs the steps of tile i.
template <bool kTma, int kStages, typename Load, typename Chain>
__device__ __forceinline__ void run_ring(uint64_t* full, int n_tiles,
                                         Load load, Chain chain) {
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  auto issue = [&](int i) {
    if (i < n_tiles) load(i, i % kStages);
    if constexpr (!kTma) commit_group();   // empty past the last tile
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_tiles; ++i) {
    if constexpr (!kTma) wait_group<kStages - 2>();   // this thread's tile i
    __syncthreads();             // every copy of tile i; tile i-1's stage read
    issue(i + kStages - 1);      // into tile i-1's stage
    if constexpr (kTma) mbar_wait(&full[i % kStages], (i / kStages) & 1);
    chain(i, i % kStages);
  }
  if constexpr (!kTma) wait_group<0>();
}

template <bool kTma>
__global__ void __launch_bounds__(kStrip)
rg_lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ out,
                   float* __restrict__ h_last, int S, int D,
                   const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto ring = reinterpret_cast<float(*)[2][kTileFloats]>(smem);
  auto full = reinterpret_cast<uint64_t*>(ring + kFwdStages);
  const int c0 = blockIdx.x * kStrip, c = c0 + threadIdx.x, row = blockIdx.y;
  const size_t base = (size_t)row * S * D;
  const bool mine = c < D;
  float h = mine ? h0[(size_t)row * D + c] : 0.f;
  float* po = out + base + c;

  auto load = [&](int k, int s) {
    const int t0 = k * kTile;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[s], sizeof(ring[s]));
        tma_load(ring[s][0], &maps.m[0], &full[s], c0, t0, row);
        tma_load(ring[s][1], &maps.m[1], &full[s], c0, t0, row);
      }
    } else {
      const int n = min(kTile, S - t0);
      copy_tile(ring[s][0], [&](int r) { return a + base + (size_t)(t0 + r) * D; },
                0, n, c0, D);
      copy_tile(ring[s][1], [&](int r) { return b + base + (size_t)(t0 + r) * D; },
                0, n, c0, D);
    }
  };
  auto chain = [&](int k, int s) {
    if (!mine) return;
    const float* sa = ring[s][0] + threadIdx.x;
    const float* sb = ring[s][1] + threadIdx.x;
    const int t0 = k * kTile, n = min(kTile, S - t0);
    auto step = [&](int r) {
      h = __fadd_rn(__fmul_rn(sa[r * kStrip], h), sb[r * kStrip]);
      po[(size_t)(t0 + r) * D] = h;
    };
    if (n == kTile) {
#pragma unroll 16
      for (int r = 0; r < kTile; ++r) step(r);
    } else {
      for (int r = 0; r < n; ++r) step(r);
    }
  };
  run_ring<kTma, kFwdStages>(full, (S + kTile - 1) / kTile, load, chain);
  if (mine) h_last[(size_t)row * D + c] = h;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The fp32 (B, S, D) tensor as a 3-D TMA map of kStrip x kTile boxes; boxes
// past its end are zero-filled. Needs D % 4 == 0 (16-byte row strides).
bool encode_f32(CUtensorMap* map, const void* ptr, int B, int S, int D) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {kStrip, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a, b, out: (B, S, D) fp32 contiguous; h0, h_last: (B, D) fp32 contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rg_lru_scan(const void* a, const void* b, const void* h0,
                           void* out, void* h_last, int B, int S, int D,
                           void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  const bool tma = D % 4 == 0 && aligned16(a) && aligned16(b);
  Maps maps{};
  if (tma && !(encode_f32(&maps.m[0], a, B, S, D) &&
               encode_f32(&maps.m[1], b, B, S, D)))
    return cudaErrorInvalidValue;
  static bool smem_set[2] = {false, false};
  auto kernel = tma ? rg_lru_scan_kernel<true> : rg_lru_scan_kernel<false>;
  constexpr size_t smem = ring_bytes<2, kFwdStages>();
  const cudaError_t err = set_smem(kernel, smem, smem_set[tma]);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kStrip - 1) / kStrip, B);
  kernel<<<grid, kStrip, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out),
      static_cast<float*>(h_last), S, D, maps);
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
// and is never read; a missing d_h_all is a template of the kernel whose
// stages hold two tiles.
//
// The forward's skeleton run backwards in time (bound, reckoning and why S is
// not split: see the top of the file): the i-th tile loaded is tile
// n_tiles-1-i. Stage row r of the tile that starts at t0 holds a_{t0+r},
// d_h_all[t0+r] and h_{t0+r-1}: the h rows sit one row behind, so tile 0's
// row 0 (t = -1) is left empty by the loads and each thread writes its h0
// there. a_{t+1} for a tile's last step is the later tile's first a, carried
// in a register.
//
// Rounding: one rounded product, then one rounded sum (__fmul_rn /
// __fadd_rn, no FMA), as the plain version (kernels/ref.py,
// rg_lru_scan_bwd_plain) computes it, so the two agree bit for bit.

namespace {

template <bool kTma, bool kHasDh>
__global__ void __launch_bounds__(kStrip)
rg_lru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ h0,
                       const float* __restrict__ d_h,
                       const float* __restrict__ d_last,
                       float* __restrict__ d_a, float* __restrict__ d_b,
                       float* __restrict__ d_h0, int S, int D,
                       const __grid_constant__ Maps maps) {
  constexpr int kInputs = kHasDh ? 3 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  auto ring = reinterpret_cast<float(*)[kInputs][kTileFloats]>(smem);
  auto full = reinterpret_cast<uint64_t*>(ring + kBwdStages);
  const int c0 = blockIdx.x * kStrip, c = c0 + threadIdx.x, row = blockIdx.y;
  const size_t base = (size_t)row * S * D;
  const int n_tiles = (S + kTile - 1) / kTile;
  const bool mine = c < D;
  float g = mine && d_last != nullptr ? d_last[(size_t)row * D + c] : 0.f;
  float a_next = 0.f;                    // a_{t+1}
  float* pda = d_a + base + c;
  float* pdb = d_b + base + c;

  auto load = [&](int i, int s) {
    const int t0 = (n_tiles - 1 - i) * kTile;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[s], sizeof(ring[s]));
        tma_load(ring[s][0], &maps.m[0], &full[s], c0, t0, row);
        tma_load(ring[s][1], &maps.m[1], &full[s], c0, t0 - 1, row);
        if constexpr (kHasDh)
          tma_load(ring[s][2], &maps.m[2], &full[s], c0, t0, row);
      }
    } else {
      const int n = min(kTile, S - t0);
      copy_tile(ring[s][0], [&](int r) { return a + base + (size_t)(t0 + r) * D; },
                0, n, c0, D);
      copy_tile(ring[s][1], [&](int r) { return h + base + (size_t)(t0 + r - 1) * D; },
                t0 == 0 ? 1 : 0, n, c0, D);
      if constexpr (kHasDh)
        copy_tile(ring[s][2], [&](int r) { return d_h + base + (size_t)(t0 + r) * D; },
                  0, n, c0, D);
    }
  };
  auto chain = [&](int i, int s) {
    if (!mine) return;
    const float* sa = ring[s][0] + threadIdx.x;
    float* sh = ring[s][1] + threadIdx.x;
    const float* sd = ring[s][kInputs - 1] + threadIdx.x;
    const int t0 = (n_tiles - 1 - i) * kTile, n = min(kTile, S - t0);
    if (t0 == 0) sh[0] = h0[(size_t)row * D + c];
    auto step = [&](int r) {
      if (t0 + r < S - 1) g = __fmul_rn(a_next, g);
      if constexpr (kHasDh) g = __fadd_rn(sd[r * kStrip], g);
      pdb[(size_t)(t0 + r) * D] = g;
      pda[(size_t)(t0 + r) * D] = __fmul_rn(g, sh[r * kStrip]);
      a_next = sa[r * kStrip];
    };
    if (n == kTile) {
#pragma unroll 16
      for (int r = kTile - 1; r >= 0; --r) step(r);
    } else {
      for (int r = n - 1; r >= 0; --r) step(r);
    }
  };
  run_ring<kTma, kBwdStages>(full, n_tiles, load, chain);
  if (mine) d_h0[(size_t)row * D + c] = __fmul_rn(a_next, g);
}

template <bool kTma, bool kHasDh>
cudaError_t launch_bwd(const float* a, const float* h, const float* h0,
                       const float* d_h, const float* d_last, float* d_a,
                       float* d_b, float* d_h0, int B, int S, int D,
                       const Maps& maps, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t smem = ring_bytes<kHasDh ? 3 : 2, kBwdStages>();
  auto kernel = rg_lru_scan_bwd_kernel<kTma, kHasDh>;
  const cudaError_t err = set_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kStrip - 1) / kStrip, B);
  kernel<<<grid, kStrip, smem, stream>>>(a, h, h0, d_h, d_last, d_a, d_b,
                                         d_h0, S, D, maps);
  return cudaGetLastError();
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
  const bool tma = D % 4 == 0 && aligned16(a) && aligned16(h) && aligned16(d_h);
  Maps maps{};
  if (tma && !(encode_f32(&maps.m[0], a, B, S, D) &&
               encode_f32(&maps.m[1], h, B, S, D) &&
               (d_h == nullptr || encode_f32(&maps.m[2], d_h, B, S, D))))
    return cudaErrorInvalidValue;
  auto launch = tma ? (d_h != nullptr ? launch_bwd<true, true> : launch_bwd<true, false>)
                    : (d_h != nullptr ? launch_bwd<false, true> : launch_bwd<false, false>);
  return launch(static_cast<const float*>(a), static_cast<const float*>(h),
                static_cast<const float*>(h0), static_cast<const float*>(d_h),
                static_cast<const float*>(d_last), static_cast<float*>(d_a),
                static_cast<float*>(d_b), static_cast<float*>(d_h0), B, S, D,
                maps, static_cast<cudaStream_t>(stream));
}
