// Grouped expert FFN for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py (moe_gemm, body
// _kernel): for every slot s of the expert-parallel dispatch,
//   y[s] = (act(x[s] @ Wg[e]) * (x[s] @ Wu[e])) @ Wd[e],   e = slot_experts[s]
// with fp32 accumulation, h = act(...) * (...) rounded to x's dtype before
// the down product (as the Pallas body casts it, moe_gemm.py:50), and the
// three activations of the Pallas kernel: swiglu (silu(g) * u), gelu (tanh
// approximation, jax.nn.gelu's default, on u) and relu (on u).
//
// The weights come as the (E, d, F) / (E, F, d) expert tensors plus an int32
// slot -> expert map, so a replica slot reads its expert's weights in place:
// the JAX package's per-step gather of a replica pool becomes one index.
//
// What bounds it on an H100: bytes. On the main path (Mixtral, d = 4096,
// F = 14336, R = 4 ranks x 3 slots = 12 slots, bf16) a launch reads 12 x
// 352 MB = 4.23 GB of weights, 1.26 ms at 3.35 TB/s. Decode has T = 8 rows
// per slot and prefill T = 128, i.e. at most 128 flops per weight byte,
// below the card's ~295 flops/byte balance point, so time is the weight
// bytes over the memory rate.
//
// Design: the rule is that each weight byte leaves HBM once per slot.
//  - Two kernels, because the fp32 (T, d) accumulator of the Pallas body at
//    d = 4096 does not fit a CTA: (1) gate/up/activation, grid (F/64, S),
//    writes h in x's dtype to a (S, T, F) scratch the wrapper allocates (the
//    Pallas body rounds h to x's dtype too, so this changes no value);
//    (2) down, grid (d/64, S). A third grid dimension walks 128-row chunks
//    when T > 128 (the main path never has more).
//  - A CTA of 8 warps holds all of its slot's rows (up to 128, warp w owns
//    rows 16w..16w+15) and walks one 64-column strip of the weights down the
//    reduction dimension in 32-deep stages, so every weight tile is loaded
//    once and used for every row.
//  - Tiles reach shared memory through a 4-stage cp.async ring (16-byte
//    copies, L2 only), so three stages of loads are in flight while one is
//    computed. Shared rows are padded (80 and 144 bytes) so ldmatrix reads
//    hit 8 distinct bank groups.
//  - bf16 products run on the tensor cores with mma.sync m16n8k16 (fp32
//    accumulators in registers; A fragments by ldmatrix, B fragments by
//    ldmatrix.trans from the row-major weight tile).
//  - Ragged T, d and F are masked: rows and columns past the end are
//    zero-filled in shared memory and never stored. When a row of x, h or a
//    weight is not a whole number of 16-byte chunks, the same tiles are
//    filled by element loads instead of cp.async.
//  - fp32 inputs (used only to check the arithmetic) take a plain FMA kernel
//    with one thread per output column and 8 rows.
// Not done yet: wgmma / TMA, and skipping weight reads for slots that
// received no pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 128;               // rows of a slot per CTA
constexpr int kBN = 64;                // output columns per CTA
constexpr int kBK = 32;                // reduction depth per stage
constexpr int kStages = 4;
constexpr int kAStride = kBK + 8;      // bf16 per shared row of x / h tiles
constexpr int kBStride = kBN + 8;      // bf16 per shared row of weight tiles
constexpr int kFThreads = 128;         // fp32 kernel: columns per CTA
constexpr int kFRows = 8;              // fp32 kernel: rows per thread

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// One stage: the (rows_pad x kBK) tile of A at reduction offset k0, and the
// (kBK x kBN) tile of each B at (k0, n0).
template <int NB>
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* A,
                                           const bf16* B0, const bf16* B1,
                                           int rows, int rows_pad, int k0,
                                           int Kd, int n0, int N, bool aligned,
                                           int tid) {
  for (int i = tid; i < rows_pad * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const int valid = r < rows ? clamp8(Kd - (k0 + c)) : 0;
    load_chunk(sA + r * kAStride + c,
               valid ? A + (size_t)r * Kd + k0 + c : A, valid, aligned);
  }
  {
    const int r = tid / (kBN / 8), c = (tid % (kBN / 8)) * 8;  // 256 chunks
    const int valid = k0 + r < Kd ? clamp8(N - (n0 + c)) : 0;
    const size_t off = (size_t)(k0 + r) * N + n0 + c;
    load_chunk(sB + r * kBStride + c, valid ? B0 + off : B0, valid, aligned);
    if (NB == 2)
      load_chunk(sB + kBK * kBStride + r * kBStride + c,
                 valid ? B1 + off : B1, valid, aligned);
  }
}

// out[s, m0 + i, n0 + j] = epilogue(A[s] @ B0[e], A[s] @ B1[e]) over the
// CTA's (<= kBM) x kBN tile. A: (S, T, Kd); B*: (E, Kd, N); out: (S, T, N).
template <int NB, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
grouped_gemm_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b0,
                  const bf16* __restrict__ b1,
                  const int32_t* __restrict__ slot_experts,
                  bf16* __restrict__ out, int T, int Kd, int N, int E,
                  int aligned_flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kAElems = kBM * kAStride;
  constexpr int kBElems = kBK * kBStride;
  constexpr int kStageElems = kAElems + NB * kBElems;

  const int s = blockIdx.y, n0 = blockIdx.x * kBN, m0 = blockIdx.z * kBM;
  const int rows = min(kBM, T - m0);
  const int rows_pad = (rows + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool aligned = aligned_flag != 0;
  const int e = slot_experts[s];
  bf16* o = out + ((size_t)s * T + m0) * N;
  if (e < 0 || e >= E) {               // no expert: the tile is zeros
    for (int i = tid; i < rows * kBN; i += kThreads) {
      const int r = i / kBN, c = n0 + i % kBN;
      if (c < N) o[(size_t)r * N + c] = __float2bfloat16(0.f);
    }
    return;
  }
  const bf16* A = a + ((size_t)s * T + m0) * Kd;
  const bf16* B0 = b0 + (size_t)e * Kd * N;
  const bf16* B1 = NB == 2 ? b1 + (size_t)e * Kd * N : B0;
  const bool active = warp * 16 < rows;

  float acc[NB][8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nb][nt][q] = 0.f;

  const int nk = (Kd + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) {
      bf16* base = smem + st * kStageElems;
      load_stage<NB>(base, base + kAElems, A, B0, B1, rows, rows_pad,
                     st * kBK, Kd, n0, N, aligned, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // stage kt landed; kt - 1 is free
    const int pf = kt + kStages - 1;
    if (pf < nk) {
      bf16* base = smem + (pf % kStages) * kStageElems;
      load_stage<NB>(base, base + kAElems, A, B0, B1, rows, rows_pad,
                     pf * kBK, Kd, n0, N, aligned, tid);
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

  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = warp * 16 + (lane >> 2) + (q >> 1) * 8;
      const int c = n0 + nt * 8 + (lane & 3) * 2 + (q & 1);
      if (r < rows && c < N) {
        const float v = epilogue<EPI>(acc[0][nt][q],
                                      NB == 2 ? acc[NB - 1][nt][q] : 0.f);
        o[(size_t)r * N + c] = __float2bfloat16(v);
      }
    }
  }
}

// fp32 kernel (checks only): a thread owns one output column for kFRows
// consecutive rows, so each weight element it loads serves kFRows rows;
// the row blocks are the fastest grid dimension, so the CTAs that share a
// weight strip run together and find it in L2.
template <int NB, int EPI>
__global__ void __launch_bounds__(kFThreads)
grouped_gemm_f32(const float* __restrict__ a, const float* __restrict__ b0,
                 const float* __restrict__ b1,
                 const int32_t* __restrict__ slot_experts,
                 float* __restrict__ out, int T, int Kd, int N, int E) {
  const int t0 = blockIdx.x * kFRows;
  const int n = blockIdx.y * kFThreads + threadIdx.x;
  const int s = blockIdx.z;
  if (n >= N) return;
  const int rows = min(kFRows, T - t0);
  const int e = slot_experts[s];
  float c0[kFRows], c1[kFRows];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) c0[r] = c1[r] = 0.f;
  const bool valid = e >= 0 && e < E;
  if (valid) {
    const float* ar = a + ((size_t)s * T + t0) * Kd;
    const float* p0 = b0 + (size_t)e * Kd * N + n;
    const float* p1 = (NB == 2 ? b1 : b0) + (size_t)e * Kd * N + n;
    for (int k = 0; k < Kd; ++k) {
      const float w0 = p0[(size_t)k * N];
      const float w1 = NB == 2 ? p1[(size_t)k * N] : 0.f;
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        if (r < rows) {
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
          valid ? epilogue<EPI>(c0[r], c1[r]) : 0.f;
}

template <int NB, int EPI>
cudaError_t launch_bf16(const void* a, const void* b0, const void* b1,
                        const int32_t* se, void* out, int S, int T, int Kd,
                        int N, int E, int aligned, cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)kStages * (kBM * kAStride + NB * kBK * kBStride) * sizeof(bf16);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_gemm_bf16<NB, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, S, (T + kBM - 1) / kBM);
  grouped_gemm_bf16<NB, EPI><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b0),
      static_cast<const bf16*>(b1), se, static_cast<bf16*>(out), T, Kd, N, E,
      aligned);
  return cudaGetLastError();
}

template <int NB, int EPI>
cudaError_t launch_f32(const void* a, const void* b0, const void* b1,
                       const int32_t* se, void* out, int S, int T, int Kd,
                       int N, int E, cudaStream_t stream) {
  const dim3 grid((T + kFRows - 1) / kFRows, (N + kFThreads - 1) / kFThreads,
                  S);
  grouped_gemm_f32<NB, EPI><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b0),
      static_cast<const float*>(b1), se, static_cast<float*>(out), T, Kd, N,
      E);
  return cudaGetLastError();
}

// Both kernels of one grouped FFN, for one element type.
template <bool BF16>
cudaError_t run(const void* x, const void* wg, const void* wu, const void* wd,
                const int32_t* se, void* h, void* out, int S, int T, int d,
                int F, int E, int act, int aligned, cudaStream_t st) {
  cudaError_t err;
#define MOE_GEMM_LAUNCH(NB, EPI, A, B0, B1, OUT, KD, N)                       \
  (BF16 ? launch_bf16<NB, EPI>(A, B0, B1, se, OUT, S, T, KD, N, E, aligned, \
                               st)                                          \
        : launch_f32<NB, EPI>(A, B0, B1, se, OUT, S, T, KD, N, E, st))
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
// dtype (0 = float32, 1 = bfloat16); slot_experts: (S,) int32; h: (S, T, F)
// scratch; out: (S, T, d). activation: 0 = swiglu, 1 = gelu, 2 = relu
// (w_gate is read only for swiglu). aligned = 1 when d and F are multiples
// of 8 and every pointer is 16-byte aligned (bf16 tiles then load with
// cp.async). Returns the first launch error (0 = both kernels launched).
extern "C" int moe_gemm(const void* x, const void* w_gate, const void* w_up,
                        const void* w_down, const void* slot_experts, void* h,
                        void* out, int S, int T, int d, int F, int E,
                        int activation, int dtype, int aligned, void* stream) {
  if (S <= 0 || T <= 0 || d <= 0 || F <= 0 || E <= 0 || S > 65535 ||
      activation < 0 || activation > 2)
    return cudaErrorInvalidValue;
  const int32_t* se = static_cast<const int32_t*>(slot_experts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if ((T + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
    return run<true>(x, w_gate, w_up, w_down, se, h, out, S, T, d, F, E,
                     activation, aligned, st);
  }
  if (dtype == 0) {
    return run<false>(x, w_gate, w_up, w_down, se, h, out, S, T, d, F, E,
                      activation, 0, st);
  }
  return cudaErrorInvalidValue;
}
