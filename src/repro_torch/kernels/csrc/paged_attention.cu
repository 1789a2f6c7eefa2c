// Paged GQA decode attention for Hopper (sm_90a), plain C interface: a
// split-KV (flash-decoding) pair of kernels.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, body _decode_kernel): one decode step per slot
// over the shared paged KV pool, with an fp32 online softmax.
//
// What bounds it on an H100: bytes. Each live K/V position is read once
// (bs x hd values per block and KV head, 2 bytes each in bf16) and used for
// G query heads only, so the function does ~G flops per byte read, far below
// the card's ~295 flops/byte balance point. The least time is the live K/V
// bytes (plus q and the output) over 3.35 TB/s. Reaching it takes a few MB
// of loads in flight across the card, so the design is about parallelism:
// one CTA per (slot, KV head) walking its blocks in order keeps too little
// in flight, however short each step is.
//
// Design: two kernels, launched back to back on one stream.
//  1. Split pass, grid (splits, K, B). CTA (s, kh, b) owns the logical
//     blocks [s*P, (s+1)*P) of slot b's table, cut to the slot's live range
//     [m_lo, m_hi] (computed from lengths[b] and window on the device). A
//     CTA whose range is empty writes m = -1e30, l = 0 and returns; blocks
//     outside the live range are never read. The CTA copies all of its K
//     and V tiles (pool[phys, :, kh, :], rows of hd values K*hd apart) into
//     shared memory at once with 16-byte cp.async.cg, K and V as two commit
//     groups, so the scores start while V is still in flight. 256 threads.
//     K is stored swizzled (16-byte chunk c of key row j at c ^ (j & 7)):
//     two threads per key (lanes l and l + 16) take every other chunk of
//     its row with no bank conflicts and add their dot products with one
//     shuffle; q sits in shared memory in fp32 and is read by broadcast.
//     One max and one sum per head cover the whole split (one warp per
//     head). Thread (kr, c) copies, and for P @ V accumulates, the 16-byte
//     column chunk c of rows kr, kr + KR, ... (KR = 256 / chunks per row),
//     for all G heads in fp32 registers (the kernel is instantiated for
//     G <= 1, 2, 4, 8, so they stay registers); the KR partial sums are
//     added through shared memory (over the K tile, dead by then). No
//     integer division by a runtime value sits on the copy or product
//     loops. The un-normalised accumulator (G, hd) and m, l per head go to
//     an fp32 workspace (B, K, splits, G, [hd]).
//  2. Combine pass, grid (B*K, G*hd / 128), one output element per thread:
//     one warp per head takes m* = max_s m_s over the splits with l > 0 and
//     w_s = exp(m_s - m*) (0 for an empty split, which is then skipped: its
//     accumulator is never written), then out = sum_s w_s acc_s /
//     max(sum_s w_s l_s, 1e-20), cast to q's dtype.
// Scores, probabilities and statistics are fp32; masked scores are -1e30
// (not -inf) and the final division uses max(l, 1e-20), as in the TPU
// kernel. The host picks P and the number of splits from the table width
// alone (kernels/paged_attention.py::split_plan), never from lengths.
//
// Not done yet (left for a later change): TMA tile copies in place of
// per-thread cp.async, mma.sync for the scores and P @ V, and folding the
// combine into the split pass (or a programmatic dependent launch) to save
// the second launch's latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;         // split pass
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;  // combine pass
constexpr int kMaxG = 8;              // query heads per KV head
constexpr int kMaxHd = 256;
constexpr size_t kMaxSmem = 232448;   // what one block may use on sm_90

// One 16-byte chunk of a K or V row, unpacked to fp32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Byte offsets of the split pass's shared memory. Mirrored by
// kernels/paged_attention.py::smem_bytes, which the split plan sizes P by.
struct Layout {
  size_t k, v, q, p, blk, total;
};
__host__ __device__ __forceinline__ Layout layout(int P, int bs, int hd,
                                                  int G, int elem) {
  const size_t tile = (size_t)P * bs * hd * elem;
  const int chunks = hd * elem / 16;  // 16-byte chunks per row
  const size_t red = (size_t)(kThreads / chunks) * G * hd * sizeof(float);
  Layout L;
  L.k = 0;                                   // K tile, then P @ V partials
  L.v = align16(tile > red ? tile : red);    // V tile
  L.q = L.v + tile;                          // q (G, hd) fp32
  L.p = L.q + (size_t)G * hd * sizeof(float);   // scores (P*bs, G) fp32
  L.blk = L.p + align16((size_t)P * bs * G * sizeof(float));
  L.total = L.blk + (size_t)P * sizeof(int);    // physical block ids
  return L;
}

// GM: a compile-time bound on G, so each thread's accumulators are registers
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q,              // (B, K, G, hd)
             const T* __restrict__ k_pool,         // (N, bs, K, hd)
             const T* __restrict__ v_pool,         // (N, bs, K, hd)
             const int32_t* __restrict__ tables,   // (B, M)
             const int32_t* __restrict__ lengths,  // (B,)
             float* __restrict__ ws_acc,           // (B, K, S, G, hd)
             float* __restrict__ ws_m,             // (B, K, S, G)
             float* __restrict__ ws_l,             // (B, K, S, G)
             int K, int G, int hd, int bs, int M, int P, int window,
             float scale) {
  constexpr int V = Chunk<T>::N;
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t split = (size_t)(b * K + kh) * gridDim.x + s;

  const int cl = lengths[b] + 1;  // the new token sits at lengths[b]
  int m_lo = 0;
  if (window > 0 && cl - window > 0) m_lo = (cl - window) / bs;
  int m_hi = (cl + bs - 1) / bs - 1;
  if (m_hi > M - 1) m_hi = M - 1;
  const int lo = max(s * P, m_lo);
  const int hi = min(s * P + P - 1, m_hi);
  if (lo > hi) {  // nothing live here: the combine pass skips l == 0
    for (int g = tid; g < G; g += kThreads) {
      ws_m[split * G + g] = kNegInf;
      ws_l[split * G + g] = 0.f;
    }
    return;
  }
  const int nblk = hi - lo + 1;
  const int n = nblk * bs;                     // keys of this split
  const int R = hd * (int)sizeof(T) / 16;      // 16-byte chunks per row
  const int swz = min(R & -R, 8) - 1;          // XOR mask of the K swizzle

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(P, bs, hd, G, sizeof(T));
  uint4* k_s = reinterpret_cast<uint4*>(smem + L.k);
  uint4* v_s = reinterpret_cast<uint4*>(smem + L.v);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  int* blk_s = reinterpret_cast<int*>(smem + L.blk);

  const int32_t* trow = tables + (size_t)b * M;
  for (int i = tid; i < nblk; i += kThreads) blk_s[i] = trow[lo + i];
  __syncthreads();

  // every K and V chunk of the split in flight at once: thread (kr, c)
  // copies chunk c of rows kr, kr + KR, ... of each block (two 256-byte
  // rows per warp instruction at hd 128 in bf16)
  const size_t row = (size_t)K * hd;  // between positions of one block
  const size_t blk = (size_t)bs * row;
  const size_t head = (size_t)kh * hd;
  const int KR = kThreads / R;
  const int kr = tid / R, c = tid % R;
  if (kr < KR) {
    for (int i = 0; i < nblk; ++i) {
      const T* src = k_pool + (size_t)blk_s[i] * blk + head + c * V;
      for (int r = kr; r < bs; r += KR) {
        const int j = i * bs + r;
        cp_async16(k_s + j * R + (c ^ (j & swz)), src + r * row);
      }
    }
  }
  cp_async_commit();
  if (kr < KR) {
    for (int i = 0; i < nblk; ++i) {
      const T* src = v_pool + (size_t)blk_s[i] * blk + head + c * V;
      for (int r = kr; r < bs; r += KR)
        cp_async16(v_s + (i * bs + r) * R + c, src + r * row);
    }
  }
  cp_async_commit();

  const T* qb = q + (size_t)(b * K + kh) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_f32(qb[i]);
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();

  // scores: two threads per key (lanes l and l + 16 of a warp), each over
  // every other 16-byte chunk of the row for all G heads, summed with one
  // shuffle; a warp covers 16 keys, the CTA kThreads / 2 per pass
  const int start = lo * bs;
  const int half = lane >> 4;
  for (int j0 = warp * 16; j0 < n; j0 += kThreads / 2) {
    const int j = j0 + (lane & 15);
    float dot[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) dot[g] = 0.f;
    if (j < n) {
#pragma unroll 2
      for (int ck = half; ck < R; ck += 2) {
        float kx[V];
        Chunk<T>::unpack(k_s[j * R + (ck ^ (j & swz))], kx);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4* qg =
                reinterpret_cast<const float4*>(q_s + g * hd + ck * V);
#pragma unroll
            for (int i = 0; i < V / 4; ++i) {
              const float4 qq = qg[i];
              dot[g] = fmaf(qq.x, kx[4 * i], dot[g]);
              dot[g] = fmaf(qq.y, kx[4 * i + 1], dot[g]);
              dot[g] = fmaf(qq.z, kx[4 * i + 2], dot[g]);
              dot[g] = fmaf(qq.w, kx[4 * i + 3], dot[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 16);
    if (j < n && half == 0) {
      const int pos = start + j;
      const bool valid = pos < cl && (window <= 0 || pos >= cl - window);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) p_s[j * G + g] = valid ? dot[g] * scale : kNegInf;
    }
  }
  __syncthreads();

  // one max and one sum per head over the whole split
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[j * G + g]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p_s[j * G + g] - mx);
      p_s[j * G + g] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ws_m[split * G + g] = mx;
      ws_l[split * G + g] = sum;
    }
  }
  cp_async_wait<0>();  // and its V copies
  __syncthreads();

  // P @ V: thread (kr, c) sums column chunk c over keys kr, kr + KR, ...
  float acc[GM][V];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[g][i] = 0.f;
  if (kr < KR) {
#pragma unroll 2
    for (int j = kr; j < n; j += KR) {
      float vx[V];
      Chunk<T>::unpack(v_s[j * R + c], vx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float p = p_s[j * G + g];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[g][i] = fmaf(p, vx[i], acc[g][i]);
        }
      }
    }
    // the KR partial sums, (KR, G, hd), over the K tile (read for the last
    // time before the two barriers above)
    float* red = reinterpret_cast<float*>(smem + L.k);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float4* dst =
            reinterpret_cast<float4*>(red + (kr * G + g) * hd + c * V);
#pragma unroll
        for (int i = 0; i < V / 4; ++i)
          dst[i] = make_float4(acc[g][4 * i], acc[g][4 * i + 1],
                               acc[g][4 * i + 2], acc[g][4 * i + 3]);
      }
    }
  }
  __syncthreads();
  const float* red = reinterpret_cast<const float*>(smem + L.k);
  float* dst = ws_acc + split * G * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    float t = 0.f;
    for (int k = 0; k < KR; ++k) t += red[k * G * hd + e];
    dst[e] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ ws_acc,  // (B, K, S, G, hd)
               const float* __restrict__ ws_m,    // (B, K, S, G)
               const float* __restrict__ ws_l,    // (B, K, S, G)
               T* __restrict__ out,               // (B, K, G, hd)
               int G, int hd, int S) {
  // grid (B*K, ceil(G*hd / kCombineThreads)): one output element per thread
  extern __shared__ float w_s[];  // (S, G) split weights, then (G,) sums
  float* den_s = w_s + S * G;
  const size_t bk = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* m = ws_m + bk * S * G;
  const float* l = ws_l + bk * S * G;
  for (int g = warp; g < G; g += kCombineThreads / 32) {
    float mx = kNegInf;
    for (int s = lane; s < S; s += 32)
      if (l[s * G + g] > 0.f) mx = fmaxf(mx, m[s * G + g]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float ls = l[s * G + g];
      // an empty split (l == 0) gets weight 0 and is skipped below
      const float w = ls > 0.f ? expf(m[s * G + g] - mx) : 0.f;
      w_s[s * G + g] = w;
      den = fmaf(w, ls, den);
    }
    den = warp_sum(den);
    if (lane == 0) den_s[g] = fmaxf(den, 1e-20f);
  }
  __syncthreads();
  const int e = blockIdx.y * kCombineThreads + threadIdx.x;
  if (e >= G * hd) return;
  const int g = e / hd;
  const float* acc = ws_acc + bk * S * G * hd + e;
  float num = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float w = w_s[s * G + g];
    // never 0 * acc: an empty split's acc was never written
    if (w > 0.f) num = fmaf(w, acc[(size_t)s * G * hd], num);
  }
  store_f32(out + bk * G * hd + e, num / den_s[g]);
}

template <typename T, int GM>
cudaError_t launch_split(const Layout& L, dim3 grid, const void* q,
                         const void* k_pool, const void* v_pool,
                         const void* tables, const void* lengths,
                         float* ws_acc, float* ws_m, float* ws_l, int K, int G,
                         int hd, int bs, int M, int P, int window, float scale,
                         cudaStream_t stream) {
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.total);
    if (e != cudaSuccess) return e;
  }
  split_kernel<T, GM><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), ws_acc, ws_m, ws_l, K, G, hd, bs,
      M, P, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out,
                   void* workspace, int B, int K, int G, int hd, int bs,
                   int M, int window, float scale, int splits, int P,
                   cudaStream_t stream) {
  if ((hd * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  const Layout L = layout(P, bs, hd, G, sizeof(T));
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  float* ws_acc = static_cast<float*>(workspace);
  float* ws_m = ws_acc + (size_t)B * K * splits * G * hd;
  float* ws_l = ws_m + (size_t)B * K * splits * G;
  const dim3 grid(splits, K, B);
  cudaError_t e;
  if (G <= 1)
    e = launch_split<T, 1>(L, grid, q, k_pool, v_pool, tables, lengths, ws_acc,
                           ws_m, ws_l, K, G, hd, bs, M, P, window, scale,
                           stream);
  else if (G <= 2)
    e = launch_split<T, 2>(L, grid, q, k_pool, v_pool, tables, lengths, ws_acc,
                           ws_m, ws_l, K, G, hd, bs, M, P, window, scale,
                           stream);
  else if (G <= 4)
    e = launch_split<T, 4>(L, grid, q, k_pool, v_pool, tables, lengths, ws_acc,
                           ws_m, ws_l, K, G, hd, bs, M, P, window, scale,
                           stream);
  else
    e = launch_split<T, 8>(L, grid, q, k_pool, v_pool, tables, lengths, ws_acc,
                           ws_m, ws_l, K, G, hd, bs, M, P, window, scale,
                           stream);
  if (e != cudaSuccess) return e;
  const size_t csmem = (size_t)(splits + 1) * G * sizeof(float);
  if (csmem > kMaxSmem) return cudaErrorInvalidValue;
  if (csmem > 48 * 1024) {
    e = cudaFuncSetAttribute(combine_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)csmem);
    if (e != cudaSuccess) return e;
  }
  combine_kernel<T><<<dim3(B * K, (G * hd + kCombineThreads - 1) /
                                      kCombineThreads),
                      kCombineThreads, csmem, stream>>>(
      ws_acc, ws_m, ws_l, static_cast<T*>(out), G, hd, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Pools and
// q must be 16-byte aligned, hd * sizeof(dtype) a multiple of 16, hd at
// most 256 and G at most 8. splits and P (blocks per split) must cover the
// table exactly: splits * P >= M > (splits - 1) * P. workspace holds
// B*K*splits*G*(hd + 2) floats: the accumulators, then m, then l.
// Launches the split pass and the combine pass on `stream` and returns
// cudaGetLastError() (0 = both launched).
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out,
                                      void* workspace, int B, int K, int G,
                                      int hd, int bs, int M, int window,
                                      float scale, int splits, int P,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > kMaxHd || hd <= 0 || G > kMaxG || G <= 0 || B <= 0 || K <= 0 ||
      bs <= 0 || M <= 0 || P <= 0 || splits <= 0 ||
      (long)splits * P < M || (long)(splits - 1) * P >= M)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lengths, out, workspace,
                         B, K, G, hd, bs, M, window, scale, splits, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out,
                                 workspace, B, K, G, hd, bs, M, window, scale,
                                 splits, P, s);
  return cudaErrorInvalidValue;
}
