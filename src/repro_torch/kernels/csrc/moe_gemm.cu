// Grouped expert FFN for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py (moe_gemm, body
// _kernel): for every slot s of the expert-parallel dispatch,
//   y[s] = (act(x[s] @ Wg[e]) * (x[s] @ Wu[e])) @ Wd[e],   e = slot_experts[s]
// with fp32 accumulation, h = act(...) * (...) rounded to x's dtype before
// the down product (as the Pallas body casts it, moe_gemm.py:50), and the
// three activations of the Pallas kernel: swiglu (silu(g) * u), gelu (tanh
// approximation, jax.nn.gelu's default, on u) and relu (on u). A slot whose
// expert is outside [0, E) gives zeros.
//
// Live rows. An optional (S, B) int32 row_counts, B dividing T, says which
// rows hold data: with Tb = T / B, rows [b*Tb, b*Tb + row_counts[s, b]) of
// slot s are live (the EP exchange's receive layout puts source rank b's
// rows at [b*cap, b*cap + count)). Every other row is taken as zero: its
// output row is zero and no weight is read for it. Without row_counts every
// row is live. The host never reads the counts.
//
// What bounds it on an H100. Decode (T = 8 rows per slot on the main path)
// is bound by weight bytes: a Mixtral expert (d = 4096, F = 14336, bf16)
// is 352 MB, 0.105 ms at 3.35 TB/s, for at most 6 * 24 * d * F flops.
// Prefill (T = 128) is 541 GFLOP over 12 slots, 0.55 ms at the bf16 peak,
// against 2.82 GB of distinct weights, 0.84 ms: both limits are near.
//
// Design. Two kernels per call, because the fp32 (T, d) accumulator of the
// Pallas body at d = 4096 does not fit a CTA: (1) gate/up/activation writes
// h in x's dtype (live rows only) to an (S, T, F) scratch the wrapper
// allocates; (2) down reads it. The host picks each launch's main loop from
// shapes alone:
//  - Decode loop (T <= 64, or rows that are not whole 16-byte chunks):
//    grid (N / 64, S). The slots that name one expert form a group. The CTA
//    of the group's first slot gathers every live row of every slot in the
//    group by index (64 rows per pass) and streams one 64-column strip of
//    the expert's weights once for all of them; the other slots' CTAs exit
//    at once, and a group without live rows reads no weights. 8 warps copy,
//    warps 0-3 own 16 gathered rows each in the products; a cp.async ring
//    (16-byte copies, L2 only) of 64-deep tiles, 4 stages with gate and up
//    and 6 with one matrix, so that two CTAs per SM keep 96-110 KB of
//    weights in flight (with 32-deep tiles the down kernel, one matrix,
//    streamed visibly slower than gate/up); rows padded to 144 bytes so
//    ldmatrix hits 8 bank groups; mma.sync m16n8k16 with fp32 accumulators (A by ldmatrix,
//    B by ldmatrix.trans from the row-major weight tile). Rows that are not
//    whole 16-byte chunks load element by element.
//  - Prefill loop (bf16, T > 64, 16-byte rows): one CTA per (128-column
//    tile, slot, 128-row tile) and three warpgroups. One producer thread
//    streams 64-deep k-tiles of x (or h) and of the weights with TMA
//    (128-byte swizzle; rows and columns past the end arrive as zeros) into
//    a ring of 4 stages (6 with one weight matrix), each with a full and an
//    empty mbarrier. Two consumer warpgroups of 64 rows issue
//    wgmma.m64n128k16 (bf16 in, fp32 out) with the (d, F) row-major weights
//    as an MN-major B operand (the descriptor's transpose bit); gate and up
//    share the A tile, and one group of products stays in flight while the
//    next stage is waited for. A row tile with no live row reads nothing.
//    CTAs are numbered so that the slots of one expert on one column tile
//    run side by side, and a replicated expert's second read of a tile hits
//    the 50 MB L2. Waves: the main path's down kernel is 32 x 12 = 384 CTAs
//    at one per SM, 2.91 waves of 132; its last wave is 91% full, about 3%
//    of the kernel, left as is: a split of k only moves the tail to another
//    fraction of a wave and adds a reduction pass. Weight tensor maps are encoded once per weight pointer
//    and cached; x's and h's per call. cuTensorMapEncodeTiled comes through
//    cudaGetDriverEntryPoint, so the build links no libcuda.
//  - fp32 inputs (used only to check the arithmetic) take a plain FMA kernel
//    with one thread per output column and 8 rows.
// Not done yet: a persistent tile scheduler, TMA stores in the epilogue,
// and wgmma with swapped operands for the decode shape.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// decode loop
constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 64;                // gathered rows per pass
constexpr int kBN = 64;                // output columns per CTA
constexpr int kBK = 64;                // reduction depth per stage
constexpr int kAStride = kBK + 8;      // bf16 per shared row of x / h tiles
constexpr int kBStride = kBN + 8;      // bf16 per shared row of weight tiles
// ring stages: 4 with gate and up (27.6 KB each), 6 with one weight matrix
// (18.4 KB each), so two CTAs share an SM either way
template <int NB>
struct RowsRing {
  static constexpr int kStages = NB == 2 ? 4 : 6;
};
constexpr int kDecodeRows = 64;        // T at or below this: the decode loop
// prefill loop
constexpr int kWThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kWM = 128;               // rows per CTA, 64 per consumer
constexpr int kWN = 128;               // output columns per CTA
constexpr int kWK = 64;                // reduction depth per stage (128 bytes)
constexpr int kSortSlots = 256;        // slots ordered by expert up to this
// fp32 kernel
constexpr int kFThreads = 128;         // columns per CTA
constexpr int kFRows = 8;              // rows per thread

enum Epilogue { kSwiglu = 0, kGelu = 1, kRelu = 2, kStore = 3 };

template <int EPI>
__device__ __forceinline__ float epilogue(float v0, float v1) {
  if (EPI == kSwiglu) return v0 / (1.f + expf(-v0)) * v1;   // silu(g) * u
  if (EPI == kGelu)
    return 0.5f * v0 *
           (1.f + tanhf(0.7978845608028654f * (v0 + 0.044715f * v0 * v0 * v0)));
  if (EPI == kRelu) return fmaxf(v0, 0.f);
  return v0;
}

// Live rows of block b of slot s: all Tb without counts, else the count
// clamped to [0, Tb].
__device__ __forceinline__ int block_live(const int32_t* counts, int s, int b,
                                          int B, int Tb) {
  if (counts == nullptr) return Tb;
  const int c = counts[(size_t)s * B + b];
  return c < 0 ? 0 : (c > Tb ? Tb : c);
}

__device__ __forceinline__ bool row_live(const int32_t* counts, int s, int t,
                                         int B, int Tb) {
  return counts == nullptr || t % Tb < block_live(counts, s, t / Tb, B, Tb);
}

// ---------------------------------------------------------------------------
// decode loop: cp.async ring + mma.sync over the rows gathered for a group
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fill one 16-byte shared chunk with src[0 .. valid) and zeros after it.
// Aligned tensors copy with cp.async (valid is then 0 or 8); others load
// element by element.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           int valid, bool aligned) {
  if (aligned) {
    cp_async16(dst, src, valid > 0 ? 16 : 0);
  } else {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = i < valid ? src[i] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ int clamp8(int n) { return n < 0 ? 0 : (n > 8 ? 8 : n); }

// One stage: the (rows_pad x kBK) tile of the gathered rows of A at
// reduction offset k0 (row r is A's row rows_idx[r]), and the (kBK x kBN)
// tile of each B at (k0, n0).
template <int NB>
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* A,
                                           const int* rows_idx,
                                           const bf16* B0, const bf16* B1,
                                           int rows, int rows_pad, int k0,
                                           int Kd, int n0, int N, bool aligned,
                                           int tid) {
  for (int i = tid; i < rows_pad * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const int valid = r < rows ? clamp8(Kd - (k0 + c)) : 0;
    load_chunk(sA + r * kAStride + c,
               valid ? A + (size_t)rows_idx[r] * Kd + k0 + c : A, valid,
               aligned);
  }
  for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const int valid = k0 + r < Kd ? clamp8(N - (n0 + c)) : 0;
    const size_t off = (size_t)(k0 + r) * N + n0 + c;
    load_chunk(sB + r * kBStride + c, valid ? B0 + off : B0, valid, aligned);
    if (NB == 2)
      load_chunk(sB + kBK * kBStride + r * kBStride + c,
                 valid ? B1 + off : B1, valid, aligned);
  }
}

// Zeros into the columns [n0, n0 + width) of slot s's rows of out (S, T,
// N): every row, or only the dead rows when dead_only.
__device__ __forceinline__ void zero_rows(bf16* out, int s, int T, int N,
                                          int n0, int width,
                                          const int32_t* counts, int B,
                                          int Tb, bool dead_only, int tid,
                                          int nthreads) {
  for (int i = tid; i < T * width; i += nthreads) {
    const int t = i / width, c = n0 + i % width;
    if (c < N && !(dead_only && row_live(counts, s, t, B, Tb)))
      out[((size_t)s * T + t) * N + c] = __float2bfloat16(0.f);
  }
}

// out[row, n0 + j] = epilogue(A[row] @ B0[e], A[row] @ B1[e]) for every
// live row of every slot that names expert e, over the CTA's kBN columns.
// A: (S, T, Kd); B*: (E, Kd, N); out: (S, T, N).
template <int NB, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
moe_gemm_rows(const bf16* __restrict__ a, const bf16* __restrict__ b0,
              const bf16* __restrict__ b1,
              const int32_t* __restrict__ slot_experts,
              const int32_t* __restrict__ counts, bf16* __restrict__ out,
              int S, int T, int Kd, int N, int E, int B, int aligned_flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_rows[kBM];
  __shared__ int s_n;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kStages = RowsRing<NB>::kStages;
  constexpr int kAElems = kBM * kAStride;
  constexpr int kBElems = kBK * kBStride;
  constexpr int kStageElems = kAElems + NB * kBElems;

  const int s = blockIdx.y, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Tb = T / B;
  const bool aligned = aligned_flag != 0;
  const int e = slot_experts[s];
  if (e < 0 || e >= E) {               // no expert: the slot's rows are zeros
    if (EPI == kStore)
      zero_rows(out, s, T, N, n0, kBN, counts, B, Tb, false, tid, kThreads);
    return;
  }
  bool led = false;                    // an earlier slot leads this group
  for (int i = tid; i < s; i += kThreads) led |= slot_experts[i] == e;
  if (__syncthreads_or(led)) return;
  if (EPI == kStore && counts != nullptr)
    for (int s2 = s; s2 < S; ++s2)
      if (slot_experts[s2] == e)
        zero_rows(out, s2, T, N, n0, kBN, counts, B, Tb, true, tid, kThreads);

  const bf16* B0 = b0 + (size_t)e * Kd * N;
  const bf16* B1 = NB == 2 ? b1 + (size_t)e * Kd * N : B0;
  const int nk = (Kd + kBK - 1) / kBK;
  int cs = s, cb = 0, ct = 0;          // thread 0's cursor over the group
  for (;;) {
    if (tid == 0) {                    // the next <= kBM live rows
      int n = 0;
      while (n < kBM && cs < S) {
        if (slot_experts[cs] != e) {
          ++cs;
          continue;
        }
        if (ct < block_live(counts, cs, cb, B, Tb)) {
          s_rows[n++] = cs * T + cb * Tb + ct++;
          continue;
        }
        ct = 0;
        if (++cb == B) {
          cb = 0;
          ++cs;
        }
      }
      s_n = n;
    }
    __syncthreads();
    const int rows = s_n;
    if (rows == 0) return;
    const int rows_pad = (rows + 15) & ~15;
    const bool active = warp * 16 < rows;

    float acc[NB][8][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nb][nt][q] = 0.f;

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) {
        bf16* base = smem + st * kStageElems;
        load_stage<NB>(base, base + kAElems, a, s_rows, B0, B1, rows,
                       rows_pad, st * kBK, Kd, n0, N, aligned, tid);
      }
      cp_async_commit();
    }

    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();                 // stage kt landed; kt - 1 is free
      const int pf = kt + kStages - 1;
      if (pf < nk) {
        bf16* base = smem + (pf % kStages) * kStageElems;
        load_stage<NB>(base, base + kAElems, a, s_rows, B0, B1, rows,
                       rows_pad, pf * kBK, Kd, n0, N, aligned, tid);
      }
      cp_async_commit();

      if (active) {
        const bf16* sA = smem + (kt % kStages) * kStageElems;
        const bf16* sB = sA + kAElems;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, sA + (warp * 16 + (lane & 15)) * kAStride + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
            for (int p = 0; p < kBN / 16; ++p) {
              uint32_t bfr[4];
              ldmatrix_x4_trans(bfr, sB + nb * kBElems +
                                         (kk * 16 + (lane & 15)) * kBStride +
                                         p * 16 + (lane >> 4) * 8);
              mma_bf16(acc[nb][2 * p], af, bfr[0], bfr[1]);
              mma_bf16(acc[nb][2 * p + 1], af, bfr[2], bfr[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();

    if (active) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = warp * 16 + (lane >> 2) + (q >> 1) * 8;
          const int c = n0 + nt * 8 + (lane & 3) * 2 + (q & 1);
          if (r < rows && c < N) {
            const float v = epilogue<EPI>(acc[0][nt][q],
                                          NB == 2 ? acc[NB - 1][nt][q] : 0.f);
            out[(size_t)s_rows[r] * N + c] = __float2bfloat16(v);
          }
        }
      }
    }
    if (rows < kBM) return;
    __syncthreads();                   // s_rows and the ring are refilled
  }
}

// ---------------------------------------------------------------------------
// prefill loop: TMA ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

// One consumer's products for one k16 step and one weight matrix: the
// 128 columns are two 64-column boxes, 8192 bytes apart (the MN-major
// operand's leading byte offset), whose 8-row k groups are 1024 bytes
// apart (its stride byte offset).
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da,
                                           const unsigned char* b) {
  wgmma_n128<0, 1>(d, da, gmma_desc(b, kBox, 1024));
}

// The prefill loop's ring: 4 stages with gate and up (48 KB each), 6 with
// one weight matrix (32 KB each), then the barriers, the slot and the row
// flags; 1024 bytes of slack align the ring for the 128-byte swizzle.
template <int NB>
struct Ring {
  static constexpr int kStages = NB == 2 ? 4 : 6;
  static constexpr int kABytes = kWM * kWK * 2;
  static constexpr int kStageBytes = kABytes + NB * 2 * kBox;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                  2 * kStages * sizeof(uint64_t) + 16 + kWM;
};

// Slots ordered by expert (out-of-range experts last), then by index.
__device__ __forceinline__ int sort_key(int e, int E) {
  return e >= 0 && e < E ? e : E;
}

// out[s, m0 + i, n0 + j] = epilogue(A[s] @ B0[e], A[s] @ B1[e]) over one
// 128 x 128 tile; A, B0, B1 arrive through their tensor maps: A (S, T, Kd)
// in 128 x 64 boxes, B* (E, Kd, N) in 64 x 64 boxes.
template <int NB, int EPI>
__global__ void __launch_bounds__(kWThreads, 1)
moe_gemm_wgmma(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_b0,
               const __grid_constant__ CUtensorMap tm_b1,
               const int32_t* __restrict__ slot_experts,
               const int32_t* __restrict__ counts, bf16* __restrict__ out,
               int S, int T, int Kd, int N, int E, int B) {
  constexpr int kStg = Ring<NB>::kStages;
  constexpr int kABytes = Ring<NB>::kABytes;
  constexpr int kStageBytes = Ring<NB>::kStageBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStg * kStageBytes);
  uint64_t* empty = full + kStg;
  int* s_slot = reinterpret_cast<int*>(empty + kStg);
  unsigned char* s_live = reinterpret_cast<unsigned char*>(s_slot + 4);

  const int tid = threadIdx.x;
  const int m_tiles = (T + kWM - 1) / kWM;
  const int mt = blockIdx.x % m_tiles;
  const int p = (blockIdx.x / m_tiles) % S;
  const int nt = blockIdx.x / (m_tiles * S);
  const int m0 = mt * kWM, n0 = nt * kWN;

  // the slot at position p of the expert order: the slots of one expert
  // on this column tile are neighbours in the launch order
  if (S > kSortSlots) {
    if (tid == 0) *s_slot = p;
  } else {
    for (int i = tid; i < S; i += kWThreads) {
      const int ki = sort_key(slot_experts[i], E);
      int rank = 0;
      for (int j = 0; j < S; ++j) {
        const int kj = sort_key(slot_experts[j], E);
        rank += kj < ki || (kj == ki && j < i);
      }
      if (rank == p) *s_slot = i;
    }
  }
  __syncthreads();
  const int s = *s_slot;
  const int e = slot_experts[s];
  const int Tb = T / B;
  int live = 0;
  if (tid < kWM) {
    const int t = m0 + tid;
    live = e >= 0 && e < E && t < T && row_live(counts, s, t, B, Tb);
    s_live[tid] = live;
  }
  if (!__syncthreads_or(live)) {       // no live row: no weight is read
    if (EPI == kStore)
      for (int i = tid; i < kWM * kWN; i += kWThreads) {
        const int t = m0 + i / kWN, c = n0 + i % kWN;
        if (t < T && c < N)
          out[((size_t)s * T + t) * N + c] = __float2bfloat16(0.f);
      }
    return;
  }
  if (tid == 0) {
    for (int i = 0; i < kStg; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);         // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (Kd + kWK - 1) / kWK;
  const int wg = tid / 128;
  if (wg == 0) {                       // producer: one thread issues TMA
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStg;
        mbar_wait(&empty[st], ((kt / kStg) & 1) ^ 1);
        mbar_expect_tx(&full[st], kStageBytes);
        unsigned char* sa = smem + st * kStageBytes;
        tma_load(sa, &tm_a, &full[st], kt * kWK, m0, s);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load(sa + kABytes + (nb * 2 + h) * kBox, nb ? &tm_b1 : &tm_b0,
                     &full[st], n0 + 64 * h, kt * kWK, e);
      }
    }
    return;
  }

  const int cw = wg - 1;               // consumer: rows 64 cw .. 64 cw + 63
  float acc[NB][64];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[nb][i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStg;
    mbar_wait(&full[st], (kt / kStg) & 1);
    const unsigned char* sa = smem + st * kStageBytes + cw * 64 * 128;
    const unsigned char* sb = smem + st * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart, k16 steps
      // 32 bytes along the row. B: 64 k-rows of 128 bytes per 64 columns,
      // the two 64-column boxes 8192 bytes apart, k16 steps 16 rows.
      const uint64_t da = gmma_desc(sa + kk * 32, 16, 1024);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_tile(acc[nb], da, sb + nb * 2 * kBox + kk * 16 * 128);
    }
    wgmma_commit();
    wgmma_wait<1>();                   // the previous stage's products ended
    if (kt > 0 && tid % 128 == 0) mbar_arrive(&empty[(kt - 1) % kStg]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);

  // accumulator i of thread (warp w, lane l): row 16 w + l / 4 + 8 ((i / 2)
  // % 2), column 8 (i / 4) + 2 (l % 4) + i % 2
  const int lane = tid & 31;
  const int r0 = cw * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8, t = m0 + r;
    const bool lv = s_live[r] != 0;
    if (t >= T || (EPI != kStore && !lv)) continue;  // a dead row's h is unread
    bf16* o = out + ((size_t)s * T + t) * N;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int c = n0 + j * 8 + (lane & 3) * 2;
      if (c >= N) continue;
      const int i = 4 * j + 2 * half;
      float v0 = epilogue<EPI>(acc[0][i], NB == 2 ? acc[NB - 1][i] : 0.f);
      float v1 = epilogue<EPI>(acc[0][i + 1],
                               NB == 2 ? acc[NB - 1][i + 1] : 0.f);
      if (!lv) v0 = v1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 kernel (checks only)
// ---------------------------------------------------------------------------

// A thread owns one output column for kFRows consecutive rows, so each
// weight element it loads serves kFRows rows; the row blocks are the fastest
// grid dimension, so the CTAs that share a weight strip run together and
// find it in L2. Dead rows compute nothing and give zeros.
template <int NB, int EPI>
__global__ void __launch_bounds__(kFThreads)
moe_gemm_f32(const float* __restrict__ a, const float* __restrict__ b0,
             const float* __restrict__ b1,
             const int32_t* __restrict__ slot_experts,
             const int32_t* __restrict__ counts, float* __restrict__ out,
             int T, int Kd, int N, int E, int B) {
  const int t0 = blockIdx.x * kFRows;
  const int n = blockIdx.y * kFThreads + threadIdx.x;
  const int s = blockIdx.z;
  if (n >= N) return;
  const int rows = min(kFRows, T - t0);
  const int e = slot_experts[s];
  const int Tb = T / B;
  bool live[kFRows];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    live[r] = r < rows && e >= 0 && e < E && row_live(counts, s, t0 + r, B, Tb);
    any |= live[r];
  }
  float c0[kFRows], c1[kFRows];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) c0[r] = c1[r] = 0.f;
  if (any) {
    const float* ar = a + ((size_t)s * T + t0) * Kd;
    const float* p0 = b0 + (size_t)e * Kd * N + n;
    const float* p1 = (NB == 2 ? b1 : b0) + (size_t)e * Kd * N + n;
    for (int k = 0; k < Kd; ++k) {
      const float w0 = p0[(size_t)k * N];
      const float w1 = NB == 2 ? p1[(size_t)k * N] : 0.f;
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        if (live[r]) {
          const float av = ar[(size_t)r * Kd + k];
          c0[r] = fmaf(av, w0, c0[r]);
          if (NB == 2) c1[r] = fmaf(av, w1, c1[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kFRows; ++r)
    if (r < rows)
      out[((size_t)s * T + t0 + r) * N + n] =
          live[r] ? epilogue<EPI>(c0[r], c1[r]) : 0.f;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int NB, int EPI>
cudaError_t launch_rows(const void* a, const void* b0, const void* b1,
                        const int32_t* se, const int32_t* counts, void* out,
                        int S, int T, int Kd, int N, int E, int B, int aligned,
                        cudaStream_t stream) {
  constexpr int kStages = RowsRing<NB>::kStages;
  constexpr size_t smem =
      (size_t)kStages * (kBM * kAStride + NB * kBK * kBStride) * sizeof(bf16);
  static bool attr_set = false;
  cudaError_t err = set_smem(moe_gemm_rows<NB, EPI>, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, S);
  moe_gemm_rows<NB, EPI><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b0),
      static_cast<const bf16*>(b1), se, counts, static_cast<bf16*>(out), S, T,
      Kd, N, E, B, aligned);
  return cudaGetLastError();
}

template <int NB, int EPI>
cudaError_t launch_wgmma(const CUtensorMap& a, const CUtensorMap& b0,
                         const CUtensorMap& b1, const int32_t* se,
                         const int32_t* counts, void* out, int S, int T, int Kd,
                         int N, int E, int B, cudaStream_t stream) {
  constexpr size_t smem = Ring<NB>::kSmem;
  static bool attr_set = false;
  cudaError_t err = set_smem(moe_gemm_wgmma<NB, EPI>, smem, attr_set);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)((N + kWN - 1) / kWN) * S *
                         ((T + kWM - 1) / kWM);
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  moe_gemm_wgmma<NB, EPI><<<(unsigned)grid, kWThreads, smem, stream>>>(
      a, b0, b1, se, counts, static_cast<bf16*>(out), S, T, Kd, N, E, B);
  return cudaGetLastError();
}

template <int NB, int EPI>
cudaError_t launch_f32(const void* a, const void* b0, const void* b1,
                       const int32_t* se, const int32_t* counts, void* out,
                       int S, int T, int Kd, int N, int E, int B,
                       cudaStream_t stream) {
  const dim3 grid((T + kFRows - 1) / kFRows, (N + kFThreads - 1) / kFThreads,
                  S);
  moe_gemm_f32<NB, EPI><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b0),
      static_cast<const float*>(b1), se, counts, static_cast<float*>(out), T,
      Kd, N, E, B);
  return cudaGetLastError();
}

// Both kernels of one grouped FFN on the prefill loop.
cudaError_t run_wgmma(const void* x, const void* wg, const void* wu,
                      const void* wd, const int32_t* se, const int32_t* counts,
                      void* h, void* out, int S, int T, int d, int F, int E,
                      int B, int act, cudaStream_t st) {
  CUtensorMap mx, mh, mg, mu, md;
  if (!encode(&mx, x, d, T, S, kWM) || !encode(&mh, h, F, T, S, kWM) ||
      !weight_map(&mu, wu, F, d, E) || !weight_map(&md, wd, d, F, E) ||
      (act == kSwiglu && !weight_map(&mg, wg, F, d, E)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (act == kSwiglu)
    err = launch_wgmma<2, kSwiglu>(mx, mg, mu, se, counts, h, S, T, d, F, E,
                                   B, st);
  else if (act == kGelu)
    err = launch_wgmma<1, kGelu>(mx, mu, mu, se, counts, h, S, T, d, F, E, B,
                                 st);
  else
    err = launch_wgmma<1, kRelu>(mx, mu, mu, se, counts, h, S, T, d, F, E, B,
                                 st);
  if (err != cudaSuccess) return err;
  return launch_wgmma<1, kStore>(mh, md, md, se, counts, out, S, T, F, d, E, B,
                                 st);
}

// Both kernels of one grouped FFN on the decode loop (bf16) or the fp32
// kernel.
template <bool BF16>
cudaError_t run_rows(const void* x, const void* wg, const void* wu,
                     const void* wd, const int32_t* se, const int32_t* counts,
                     void* h, void* out, int S, int T, int d, int F, int E,
                     int B, int act, int aligned, cudaStream_t st) {
  cudaError_t err;
#define MOE_GEMM_LAUNCH(NB, EPI, A, B0, B1, OUT, KD, N)                     \
  (BF16 ? launch_rows<NB, EPI>(A, B0, B1, se, counts, OUT, S, T, KD, N, E, \
                               B, aligned, st)                            \
        : launch_f32<NB, EPI>(A, B0, B1, se, counts, OUT, S, T, KD, N, E, \
                              B, st))
  if (act == kSwiglu)
    err = MOE_GEMM_LAUNCH(2, kSwiglu, x, wg, wu, h, d, F);
  else if (act == kGelu)
    err = MOE_GEMM_LAUNCH(1, kGelu, x, wu, wu, h, d, F);
  else
    err = MOE_GEMM_LAUNCH(1, kRelu, x, wu, wu, h, d, F);
  if (err != cudaSuccess) return err;
  return MOE_GEMM_LAUNCH(1, kStore, h, wd, wd, out, F, d);
#undef MOE_GEMM_LAUNCH
}

}  // namespace

// x: (S, T, d); w_gate, w_up: (E, d, F); w_down: (E, F, d), all of one
// dtype (0 = float32, 1 = bfloat16); slot_experts: (S,) int32; row_counts:
// (S, B) int32 with T % B == 0, or null (every row live); h: (S, T, F)
// scratch; out: (S, T, d). activation: 0 = swiglu, 1 = gelu, 2 = relu
// (w_gate is read only for swiglu). aligned = 1 when d and F are multiples
// of 8 and every pointer is 16-byte aligned (bf16 tiles then load with
// cp.async or TMA). Returns the first launch error (0 = both kernels
// launched).
extern "C" int moe_gemm(const void* x, const void* w_gate, const void* w_up,
                        const void* w_down, const void* slot_experts,
                        const void* row_counts, void* h, void* out, int S,
                        int T, int d, int F, int E, int B, int activation,
                        int dtype, int aligned, void* stream) {
  if (S <= 0 || T <= 0 || d <= 0 || F <= 0 || E <= 0 || S > 65535 ||
      B <= 0 || T % B != 0 || activation < 0 || activation > 2)
    return cudaErrorInvalidValue;
  const int32_t* se = static_cast<const int32_t*>(slot_experts);
  const int32_t* counts = static_cast<const int32_t*>(row_counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (aligned && T > kDecodeRows)
      return run_wgmma(x, w_gate, w_up, w_down, se, counts, h, out, S, T, d,
                       F, E, B, activation, st);
    return run_rows<true>(x, w_gate, w_up, w_down, se, counts, h, out, S, T,
                          d, F, E, B, activation, aligned, st);
  }
  if (dtype == 0) {
    return run_rows<false>(x, w_gate, w_up, w_down, se, counts, h, out, S, T,
                           d, F, E, B, activation, 0, st);
  }
  return cudaErrorInvalidValue;
}
