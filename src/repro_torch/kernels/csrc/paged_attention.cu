// Paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, body _decode_kernel): one decode step per slot
// over the shared paged KV pool, with an fp32 online softmax.
//
// What bounds it on an H100: bytes. Each live K/V position is read once
// (bs x hd values per block and KV head, 2 bytes each in bf16) and used for
// G query heads only, so the kernel does ~G flops per byte read, far below
// the card's ~295 flops/byte balance point. The least time is the live
// K/V bytes (plus q and the output) over 3.35 TB/s.
//
// Design: one CTA per (slot b, KV head k) handles the G query heads that
// share that head's K/V, so each K/V tile is read once for all G heads. The
// CTA loads its own lengths[b] and walks block_tables[b, m] over only the
// live blocks, from max(0, (cl - window) / bs) (when window > 0) to
// ceil(cl / bs) - 1, cl = lengths[b] + 1: dead blocks are never read (the
// TPU kernel still DMAs the null block and only skips compute). Each
// (bs, hd) tile sits at pool[phys, :, k, :] — rows of hd contiguous values,
// K*hd apart. A CTA walks its blocks one after another, so what each block
// costs is latency, and the design keeps it short:
//  - all threads copy a block's K and V tiles into shared memory together,
//    in 16-byte loads that are all in flight at once;
//  - the loads of block m+1 are issued into registers before block m is
//    computed, and stored into the other half of a double buffer after, so
//    the memory round trip overlaps the compute;
//  - each thread keeps its output columns' accumulators for all G heads in
//    registers, and one warp per head reduces the softmax statistics with
//    shuffles.
// Scores, probabilities and the running max / denominator are fp32. Masked
// scores are -1e30 (not -inf) and the final division uses max(l, 1e-20), as
// in the TPU kernel.
//
// Not done yet (left for a later change): B*K CTAs under-fill the 132 SMs
// at small batch, and a long slot still walks its blocks in order. A split
// over blocks (flash-decoding) with a second reduction pass, and TMA tiles,
// are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxHdPerLane = 8;    // hd <= 256
constexpr int kMaxCols = 256 / kThreads;  // output columns per thread
constexpr int kMaxG = 8;            // query heads per KV head
constexpr int kLoadsPerThread = 4;  // 16-byte loads per thread per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One block's K and V tiles, as 16-byte vectors held in registers between
// their loads from the pool and their stores into shared memory.
struct Tile {
  uint4 k[kLoadsPerThread], v[kLoadsPerThread];
};

template <typename T>
__device__ __forceinline__ void load_tile(Tile& t, const T* k_pool,
                                          const T* v_pool, size_t base,
                                          size_t row, int row_vecs,
                                          int tile_vecs, int tid) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kLoadsPerThread; ++u) {
    const int i = u * kThreads + tid;
    if (i < tile_vecs) {
      const size_t off =
          base + (size_t)(i / row_vecs) * row + (i % row_vecs) * kVec;
      t.k[u] = *reinterpret_cast<const uint4*>(k_pool + off);
      t.v[u] = *reinterpret_cast<const uint4*>(v_pool + off);
    }
  }
}

__device__ __forceinline__ void store_tile(const Tile& t, uint4* k_s,
                                           uint4* v_s, int tile_vecs,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < kLoadsPerThread; ++u) {
    const int i = u * kThreads + tid;
    if (i < tile_vecs) {
      k_s[i] = t.k[u];
      v_s[i] = t.v[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const T* __restrict__ q,             // (B, K, G, hd)
                    const T* __restrict__ k_pool,        // (N, bs, K, hd)
                    const T* __restrict__ v_pool,        // (N, bs, K, hd)
                    const int32_t* __restrict__ tables,  // (B, M)
                    const int32_t* __restrict__ lengths, // (B,)
                    T* __restrict__ out,                 // (B, K, G, hd)
                    int K, int G, int hd, int bs, int M, int window,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = bs * hd;
  T* kv_s = reinterpret_cast<T*>(smem_raw);  // [2][K tile, V tile]
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * tile);  // (G, hd)
  float* p_s = q_s + G * hd;    // (G, bs) scores, then probabilities
  float* m_run = p_s + G * bs;  // (G,) running max
  float* l_run = m_run + G;     // (G,) running denominator
  float* corr = l_run + G;      // (G,) this block's rescale factor

  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  const T* qb = q + (size_t)(b * K + kh) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }
  float acc[kMaxCols][kMaxG];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[c][g] = 0.f;

  const int cl = lengths[b] + 1;  // the new token sits at lengths[b]
  int m_lo = 0;
  if (window > 0 && cl - window > 0) m_lo = (cl - window) / bs;
  int m_hi = (cl + bs - 1) / bs - 1;
  if (m_hi > M - 1) m_hi = M - 1;
  const size_t row = (size_t)K * hd;  // between positions of one block
  const size_t blk = (size_t)bs * row;
  const int row_vecs = hd / (16 / (int)sizeof(T));
  const int tile_vecs = bs * row_vecs;
  const int32_t* trow = tables + (size_t)b * M;
  const size_t head = (size_t)kh * hd;

  Tile next;
  if (m_lo <= m_hi) {
    load_tile(next, k_pool, v_pool, (size_t)trow[m_lo] * blk + head, row,
              row_vecs, tile_vecs, tid);
    store_tile(next, reinterpret_cast<uint4*>(kv_s),
               reinterpret_cast<uint4*>(kv_s + tile), tile_vecs, tid);
  }
  __syncthreads();

  for (int m = m_lo, buf = 0; m <= m_hi; ++m, buf ^= 1) {
    const T* k_s = kv_s + 2 * buf * tile;
    const T* v_s = k_s + tile;
    // the next block's loads are in flight while this one is computed
    if (m < m_hi)
      load_tile(next, k_pool, v_pool, (size_t)trow[m + 1] * blk + head, row,
                row_vecs, tile_vecs, tid);
    const int start = m * bs;

    // scores: one warp per key row
    for (int j = warp; j < bs; j += kWarps) {
      float kr[kMaxHdPerLane];
#pragma unroll
      for (int i = 0; i < kMaxHdPerLane; ++i) {
        const int d = lane + 32 * i;
        kr[i] = d < hd ? to_f32(k_s[j * hd + d]) : 0.f;
      }
      const int pos = start + j;
      const bool valid = pos < cl && (window <= 0 || pos >= cl - window);
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxHdPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) part += q_s[g * hd + d] * kr[i];
        }
        part = warp_sum(part);
        if (lane == 0) p_s[g * bs + j] = valid ? part * scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = p_s + g * bs;
      float m_new = m_run[g];
      for (int j = lane; j < bs; j += 32) m_new = fmaxf(m_new, sg[j]);
      m_new = warp_max(m_new);
      float sum = 0.f;
      for (int j = lane; j < bs; j += 32) {
        const float p = expf(sg[j] - m_new);
        sg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_run[g] - m_new);
        corr[g] = c;
        l_run[g] = l_run[g] * c + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V: each thread owns output columns d and
    // reads each V value once for all G heads
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = tid + c * kThreads;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[c][g] *= corr[g];
        for (int j = 0; j < bs; ++j) {
          const float v = to_f32(v_s[j * hd + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[c][g] += p_s[g * bs + j] * v;
        }
      }
    }
    if (m < m_hi) {
      T* k_n = kv_s + 2 * (buf ^ 1) * tile;
      store_tile(next, reinterpret_cast<uint4*>(k_n),
                 reinterpret_cast<uint4*>(k_n + tile), tile_vecs, tid);
    }
    __syncthreads();
  }

  T* ob = out + (size_t)(b * K + kh) * G * hd;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int d = tid + c * kThreads;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G)
          store_f32(ob + g * hd + d, acc[c][g] / fmaxf(l_run[g], 1e-20f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out, int B,
                   int K, int G, int hd, int bs, int M, int window,
                   float scale, cudaStream_t stream) {
  // a tile must be whole 16-byte loads, at most kLoadsPerThread per thread
  if ((hd * sizeof(T)) % 16 != 0 ||
      (size_t)bs * hd * sizeof(T) > 16 * kLoadsPerThread * kThreads)
    return cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)bs * hd * sizeof(T) +
                      (size_t)(G * hd + G * bs + 3 * G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_kernel<T><<<B * K, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), K, G, hd,
      bs, M, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Pools and
// q must be 16-byte aligned, hd * sizeof(dtype) a multiple of 16, a
// (bs, hd) tile at most 8 KiB, and G at most 8.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out, int B,
                                      int K, int G, int hd, int bs, int M,
                                      int window, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 32 * kMaxHdPerLane || G > kMaxG || G <= 0 || B <= 0 || K <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lengths, out, B, K, G, hd,
                         bs, M, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B,
                                 K, G, hd, bs, M, window, scale, s);
  return cudaErrorInvalidValue;
}
