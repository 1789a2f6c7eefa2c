// Gradient of the grouped expert FFN for Hopper (sm_90a), plain C interface.
//
// The forward (moe_gemm.cu, the port of src/repro/kernels/moe_gemm.py) is
//   y[s] = (act(x[s] @ Wg[e]) * (x[s] @ Wu[e])) @ Wd[e],   e = slot_experts[s]
// with fp32 accumulation and h = act(g) * u rounded to x's dtype before the
// down product. The TPU package has no backward kernel: its trainer lets
// jax.grad differentiate the einsum grouped_ffn (src/repro/moe/dispatch.py).
// This is that gradient, written by hand because the forward is a kernel.
// Given dy (S, T, d), per live row of slot s with expert e:
//   g = x Wg[e], u = x Wu[e], dh = dy Wd[e]^T              (fp32 sums)
//   swiglu: h = silu(g) u, dg = dh u silu'(g), du = dh silu(g)
//   gelu:   h = gelu(u) (tanh form), du = dh gelu'(u)
//   relu:   h = relu(u), du = dh [u > 0]
// h, dg and du are rounded to x's dtype; then
//   dx = dg Wg[e]^T + du Wu[e]^T                 (one fp32 sum over 2F)
//   dWg[e] = sum x^T dg, dWu[e] = sum x^T du, dWd[e] = sum h^T dy
// where the weight sums run over every live row of every slot that names
// row e of the weight tensors, slots ascending, then rows (a replica slot
// naming its expert's home row adds into that row). A dead row (row_counts
// as in the forward) gives dx = 0 and adds nothing, whatever it holds; a slot
// outside [0, E) gives zeros; a weight row no live row names gets zeros.
//
// What bounds it on an H100. The training step's layer (8 slots of 4 x 160
// rows, ~4096 live, d = 4096, F = 14336) does 8 products of 2 rows d F
// flops, 3.85 TFLOP, 3.9 ms at the dense bf16 peak, against ~5.7 GB of
// weights, activations and gradients, 1.7 ms: bound by operations.
//
// Design (simple first: mma.sync, not wgmma). Five launches per call:
//  0. moe_bwd_rows (one CTA): each slot's live rows, and each weight row's live
//     rows in slot order, as lists of (s * T + t) in an int32 scratch, so
//     the product kernels gather rows by index and never see a dead one.
//  1. moe_bwd_hidden: per (128 live rows of a slot, 64 columns of F) the three
//     products over d that share the output tile (x Wg, x Wu, dy Wd^T),
//     then the epilogue writes h, dg and du in x's dtype to (S, T, F)
//     scratch the wrapper allocates.
//  2. moe_bwd_input: per (128 row positions of a slot, 64 columns of d): zeros
//     into the dead rows of those positions, then dx of 128 live rows as
//     one sum over (dg, Wg) and (du, Wu).
//  3. moe_bwd_weight<2>: per (weight row e, 128 x 64 tile of (d, F)) x^T dg and
//     x^T du over e's row list (the A tile arrives k-major and loads with
//     ldmatrix.trans); 4. moe_bwd_weight<1>: h^T dy into dWd the same way.
// Every product kernel is one tile loop: 8 warps as 4 x 2 warp tiles of 32
// x 32, k steps of 64 (hidden, input: 3 stages) or 32 (weights, whose row
// lists are short: 4 stages) through a cp.async ring (16-byte copies, L2
// only; rows padded by 16 bytes so ldmatrix hits 8 bank groups), mma.sync
// m16n8k16 bf16 -> fp32. Each operand tile is a list of rows times a
// column window, loaded with ldmatrix or ldmatrix.trans as its layout
// needs: x, dy, dg and du as rows (K contiguous), Wg / Wu in the forward
// direction as (k, n) rows and Wd (for dh) and Wg / Wu (for dx) as (n, k)
// rows, x and h as (k, m) rows for the weight gradients. A thread's copies
// keep their source addresses from one k step to the next (address
// arithmetic per chunk and step would take more instruction slots than the
// products), and the epilogues store column pairs. No atomics: each output
// element is written by one CTA, in a fixed order, so repeated calls are
// bit-identical. fp32 inputs (used only to check the arithmetic) take plain
// FMA kernels over the same row lists.
// On an H100 SXM (700 W) at the train step's layer: 19.0 ms, ~205 TFLOP/s,
// 0.20 of the bound (chip_smoke.py, PERF.md).
// Not done yet: wgmma and TMA, a persistent scheduler, larger warp tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps: 4 (rows) x 2 (columns)
constexpr int kBM = 128;               // output rows per CTA
constexpr int kBN = 64;                // output columns per CTA
constexpr int kPad = 8;                // bf16 of padding per shared row
// reduction depth per stage and ring stages, per kernel: 64 for the hidden
// and input kernels, whose reductions run over d and 2F; 32 for the weight
// kernels, whose reductions run over one expert's rows (~500 at the train
// step's layer), so that their rings fill in fewer rows
constexpr int kHiddenBK = 64, kHiddenStages = 3;
constexpr int kInputBK = 64, kInputStages = 3;
constexpr int kWeightBK = 32, kWeightStages = 4;
constexpr int kPrepThreads = 1024;
constexpr int kFThreads = 128;         // fp32 kernels: columns per CTA
constexpr int kFRows = 8;              // fp32 kernels: rows per thread

enum Act { kSwiglu = 0, kGelu = 1, kRelu = 2 };

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

// The epilogue of the hidden gradient: h, dg (swiglu only) and du of one
// element from its fp32 sums g, u and dh.
template <int ACT>
__device__ __forceinline__ void hidden_grad(float g, float u, float dh,
                                            float& h, float& dg, float& du) {
  if (ACT == kSwiglu) {
    const float sg = 1.f / (1.f + expf(-g));
    const float a = g * sg;
    h = a * u;
    dg = dh * u * (sg * (1.f + g * (1.f - sg)));
    du = dh * a;
  } else if (ACT == kGelu) {
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;
    const float t = tanhf(k0 * (u + k1 * u * u * u));
    h = 0.5f * u * (1.f + t);
    du = dh * (0.5f * (1.f + t) +
               0.5f * u * (1.f - t * t) * k0 * (1.f + 3.f * k1 * u * u));
    dg = 0.f;
  } else {
    h = fmaxf(u, 0.f);
    du = u > 0.f ? dh : 0.f;
    dg = 0.f;
  }
}

// ---------------------------------------------------------------------------
// 0. row lists
// ---------------------------------------------------------------------------

// index = [slot_start (S) | slot_n (S) | exp_off (E + 1) | rows (S * T)]:
// slot s's live rows are rows[slot_start[s] .. + slot_n[s]); weight row e's
// are rows[exp_off[e] .. exp_off[e + 1]), the runs of the slots naming it
// in slot order. A row is s * T + t.
__global__ void __launch_bounds__(kPrepThreads)
moe_bwd_rows(const int32_t* __restrict__ se, const int32_t* __restrict__ counts,
         int32_t* __restrict__ index, int S, int T, int E, int B) {
  int32_t* slot_start = index;
  int32_t* slot_n = index + S;
  int32_t* exp_off = index + 2 * S;
  int32_t* rows = index + 2 * S + E + 1;
  const int Tb = T / B;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int e = se[s];
    int n = 0;
    if (e >= 0 && e < E)
      for (int b = 0; b < B; ++b) n += block_live(counts, s, b, B, Tb);
    slot_n[s] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int e = 0; e <= E; ++e) exp_off[e] = 0;
    for (int s = 0; s < S; ++s) {
      const int e = se[s];
      if (e >= 0 && e < E) exp_off[e + 1] += slot_n[s];
    }
    for (int e = 0; e < E; ++e) exp_off[e + 1] += exp_off[e];
    for (int s = 0; s < S; ++s) {       // exp_off[e] walks to e's end
      const int e = se[s];
      slot_start[s] = 0;
      if (e >= 0 && e < E) {
        slot_start[s] = exp_off[e];
        exp_off[e] += slot_n[s];
      }
    }
    for (int e = E; e > 0; --e) exp_off[e] = exp_off[e - 1];
    exp_off[0] = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < S; s += blockDim.x >> 5) {
    if (slot_n[s] == 0) continue;
    int at = slot_start[s];
    for (int b = 0; b < B; ++b) {
      const int c = block_live(counts, s, b, B, Tb);
      for (int i = lane; i < c; i += 32) rows[at + i] = s * T + b * Tb + i;
      at += c;
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 tile loop: cp.async ring + ldmatrix + mma.sync
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ int clamp8(int n) {
  return n < 0 ? 0 : (n > 8 ? 8 : n);
}

// One 16-byte shared chunk from src[0 .. valid), zeros after it. Aligned
// tensors copy with cp.async (valid is then 0 or 8); others element-wise.
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

// The 16-byte chunks a thread copies of a ROWS x COLS shared tile (row
// stride COLS + kPad): chunk j is tile row row(j), columns col(j) .. + 8.
// Each loader below keeps what a k step cannot change (the chunk's source
// address at k = 0, how far it may read), so that a k step costs an add, a
// compare and the copy per chunk.
template <int ROWS, int COLS>
struct Chunks {
  static constexpr int kTotal = ROWS * COLS / 8;
  static constexpr int kPer = (kTotal + kThreads - 1) / kThreads;
  __device__ static int index(int j) { return threadIdx.x + j * kThreads; }
  __device__ static bool has(int j) {
    return kTotal % kThreads == 0 || index(j) < kTotal;
  }
  __device__ static int row(int j) { return index(j) / (COLS / 8); }
  __device__ static int col(int j) { return index(j) % (COLS / 8) * 8; }
  __device__ static int dst(int j) { return row(j) * (COLS + kPad) + col(j); }
};

// Rows fixed, k along them: tile row r holds columns [k0, k0 + COLS) of
// the row row(r) points to (ncols long; null: zeros).
template <int ROWS, int COLS>
struct AlongRows {
  using C = Chunks<ROWS, COLS>;
  const bf16* src[C::kPer];
  int lim[C::kPer];                    // columns left to read at k0 = 0
  template <class Row>
  __device__ void init(Row row, int ncols, const bf16* any) {
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) {
      const bf16* p = C::has(j) ? row(C::row(j)) : nullptr;
      src[j] = p != nullptr ? p + C::col(j) : any;
      lim[j] = p != nullptr ? ncols - C::col(j) : 0;
    }
  }
  __device__ void load(bf16* tile, int k0, bool aligned) const {
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) {
      if (!C::has(j)) continue;
      const int valid = clamp8(lim[j] - k0);
      load_chunk(tile + C::dst(j), valid ? src[j] + k0 : src[j], valid,
                 aligned);
    }
  }
};

// k down the rows: tile row r is row k0 + r of a (nrows, ld) matrix,
// columns [c0, c0 + COLS) of its ncols.
template <int ROWS, int COLS>
struct DownRows {
  using C = Chunks<ROWS, COLS>;
  const bf16* src[C::kPer];
  int rows_left[C::kPer], valid[C::kPer];
  size_t ld;
  __device__ void init(const bf16* m, int nrows, size_t ld_, int c0,
                       int ncols) {
    ld = ld_;
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) {
      src[j] = m + C::row(j) * ld + c0 + C::col(j);
      rows_left[j] = C::has(j) ? nrows - C::row(j) : 0;
      valid[j] = clamp8(ncols - (c0 + C::col(j)));
    }
  }
  __device__ void load(bf16* tile, int k0, const bf16* any,
                       bool aligned) const {
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) {
      if (!C::has(j)) continue;
      const int v = k0 < rows_left[j] ? valid[j] : 0;
      load_chunk(tile + C::dst(j), v ? src[j] + k0 * ld : any, v, aligned);
    }
  }
};

// k down a row list: tile row r is row list[k0 + r] (k0 + r < n) of a
// matrix of ld-long rows, columns [c0, c0 + COLS) of its ncols.
template <int ROWS, int COLS>
struct ListedRows {
  using C = Chunks<ROWS, COLS>;
  const bf16* src[C::kPer];
  int rows_left[C::kPer], valid[C::kPer];
  const int32_t* list;
  size_t ld;
  __device__ void init(const bf16* m, const int32_t* list_, int n, size_t ld_,
                       int c0, int ncols) {
    list = list_;
    ld = ld_;
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) {
      src[j] = m + c0 + C::col(j);
      rows_left[j] = C::has(j) ? n - C::row(j) : 0;
      valid[j] = clamp8(ncols - (c0 + C::col(j)));
    }
  }
  __device__ void load(bf16* tile, int k0, const bf16* any,
                       bool aligned) const {
#pragma unroll
    for (int j = 0; j < C::kPer; ++j) {
      if (!C::has(j)) continue;
      const int v = k0 < rows_left[j] ? valid[j] : 0;
      load_chunk(tile + C::dst(j),
                 v ? src[j] + (size_t)list[k0 + C::row(j)] * ld : any, v,
                 aligned);
    }
  }
};

// A fragments of the warp's two 16-row blocks from m0, depth kk..kk+16:
// from an (m, k) tile, or with KM from a (k, m) tile through ldmatrix.trans.
template <bool KM, int STRIDE>
__device__ __forceinline__ void a_frags(uint32_t (&a)[2][4], const bf16* tile,
                                        int m0, int kk, int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = m0 + mi * 16;
    if (!KM)
      ldmatrix_x4(a[mi], tile + (m + (lane & 15)) * STRIDE + kk +
                             (lane >> 4) * 8);
    else
      ldmatrix_x4_trans(a[mi], tile + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                          STRIDE +
                                   m + ((lane >> 3) & 1) * 8);
  }
}

// B fragments of the warp's four 8-column blocks from n0, depth kk..kk+16:
// from a (k, n) tile through ldmatrix.trans, or with NK from an (n, k) tile.
template <bool NK, int STRIDE>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4][2], const bf16* tile,
                                        int n0, int kk, int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    const int n = n0 + p * 16;
    if (!NK)
      ldmatrix_x4_trans(r, tile + (kk + (lane & 15)) * STRIDE + n +
                               (lane >> 4) * 8);
    else
      ldmatrix_x4(r, tile + (n + (lane & 7) + ((lane >> 4) << 3)) * STRIDE +
                         kk + ((lane >> 3) & 1) * 8);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
}

using Acc = float[2][4][4];            // a warp's 32 x 32 fp32 tile

__device__ __forceinline__ void zero_acc(Acc& c) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[i][j][q] = 0.f;
}

__device__ __forceinline__ void mma_tile(Acc& c, const uint32_t (&a)[2][4],
                                         const uint32_t (&b)[4][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(c[i][j], a[i], b[j][0], b[j][1]);
}

// The ring: load(stage, kt) starts the copies of k step kt, compute(stage)
// consumes a landed stage.
template <int kStages, class Load, class Compute>
__device__ __forceinline__ void pipeline(int nk, Load load, Compute compute) {
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // stage kt landed; kt - 1 is free
    const int pf = kt + kStages - 1;
    if (pf < nk) load(pf % kStages, pf);
    cp_async_commit();
    compute(kt % kStages);
  }
  cp_async_wait<0>();
}

// Element (i, j, q) of a warp's accumulators: row and column in the CTA tile.
__device__ __forceinline__ int acc_row(int wm, int lane, int i, int q) {
  return wm * 32 + i * 16 + (lane >> 2) + (q >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int wn, int lane, int j, int q) {
  return wn * 32 + j * 8 + (lane & 3) * 2 + (q & 1);
}

// Columns c and c + 1 of one output row from two fp32 values: one 4-byte
// store where both are in range and p is 4-byte aligned, else one each.
__device__ __forceinline__ void store2(bf16* p, float v0, float v1,
                                       bool both) {
  if (both && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (both) p[1] = __float2bfloat16(v1);
  }
}

// shared tile sizes (bf16) at depth BK
template <int BK>
struct Tile {
  static constexpr int kAK = kBM * (BK + kPad);   // (m, k) row tile
  static constexpr int kKN = BK * (kBN + kPad);   // (k, n) tile
  static constexpr int kNK = kBN * (BK + kPad);   // (n, k) tile
  static constexpr int kKM = BK * (kBM + kPad);   // (k, m) tile
};

template <int ACT>
struct Hidden {
  static constexpr int kGates = ACT == kSwiglu ? 2 : 1;    // (Wg,) Wu tiles
  using Tl = Tile<kHiddenBK>;
  static constexpr int kStage = 2 * Tl::kAK + kGates * Tl::kKN + Tl::kNK;
  static constexpr size_t kSmem = (size_t)kHiddenStages * kStage *
                                  sizeof(bf16);
};

// 1. h, dg and du of 128 live rows of slot blockIdx.z over columns
// [n0, n0 + 64) of F: x Wu[e] (and x Wg[e]) and dy Wd[e]^T over d.
template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
moe_bwd_hidden(const bf16* __restrict__ x, const bf16* __restrict__ dy,
           const bf16* __restrict__ wg, const bf16* __restrict__ wu,
           const bf16* __restrict__ wd, const int32_t* __restrict__ se,
           const int32_t* __restrict__ index, bf16* __restrict__ h,
           bf16* __restrict__ dg, bf16* __restrict__ du, int S, int d, int F,
           int E, int aligned_flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_rows[kBM];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr bool kGate = ACT == kSwiglu;
  constexpr int kStage = Hidden<ACT>::kStage, kBK = kHiddenBK;
  constexpr int kAK = Tile<kBK>::kAK, kKN = Tile<kBK>::kKN;
  const int s = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int e = se[s];
  const int n_live = index[S + s];
  if (e < 0 || e >= E || m0 >= n_live) return;
  const int rows = min(kBM, n_live - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const bool aligned = aligned_flag != 0;
  for (int r = tid; r < rows; r += kThreads)
    s_rows[r] = index[2 * S + E + 1 + index[s] + m0 + r];
  __syncthreads();

  const bf16* Wu = wu + (size_t)e * d * F;
  const bf16* Wg = kGate ? wg + (size_t)e * d * F : Wu;
  const bf16* Wd = wd + (size_t)e * F * d;
  Acc acc_g, acc_u, acc_h;
  zero_acc(acc_g);
  zero_acc(acc_u);
  zero_acc(acc_h);

  AlongRows<kBM, kBK> lx, ldy;
  lx.init([&](int r) {
    return r < rows ? x + (size_t)s_rows[r] * d : nullptr;
  }, d, x);
  ldy.init([&](int r) {
    return r < rows ? dy + (size_t)s_rows[r] * d : nullptr;
  }, d, dy);
  DownRows<kBK, kBN> lu, lg;
  lu.init(Wu, d, F, n0, F);
  if (kGate) lg.init(Wg, d, F, n0, F);
  AlongRows<kBN, kBK> lwd;
  lwd.init([&](int r) {
    return n0 + r < F ? Wd + (size_t)(n0 + r) * d : nullptr;
  }, d, Wd);
  auto load = [&](int st, int kt) {
    bf16* base = smem + st * kStage;
    const int k0 = kt * kBK;
    lx.load(base, k0, aligned);
    ldy.load(base + kAK, k0, aligned);
    lu.load(base + 2 * kAK, k0, Wu, aligned);
    if (kGate) lg.load(base + 2 * kAK + kKN, k0, Wg, aligned);
    lwd.load(base + 2 * kAK + Hidden<ACT>::kGates * kKN, k0, aligned);
  };
  auto compute = [&](int st) {
    const bf16* base = smem + st * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ax[2][4], ad[2][4], b[4][2];
      a_frags<false, kBK + kPad>(ax, base, wm * 32, kk, lane);
      a_frags<false, kBK + kPad>(ad, base + kAK, wm * 32, kk, lane);
      b_frags<false, kBN + kPad>(b, base + 2 * kAK, wn * 32, kk, lane);
      mma_tile(acc_u, ax, b);
      if (kGate) {
        b_frags<false, kBN + kPad>(b, base + 2 * kAK + kKN, wn * 32, kk, lane);
        mma_tile(acc_g, ax, b);
      }
      b_frags<true, kBK + kPad>(b, base + 2 * kAK + Hidden<ACT>::kGates * kKN,
                                wn * 32, kk, lane);
      mma_tile(acc_h, ad, b);
    }
  };
  pipeline<kHiddenStages>((d + kBK - 1) / kBK, load, compute);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int r = acc_row(wm, lane, i, q);
        const int c = n0 + acc_col(wn, lane, j, q);
        if (r >= rows || c >= F) continue;
        float hv[2], dgv[2], duv[2];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          hidden_grad<ACT>(acc_g[i][j][q + p], acc_u[i][j][q + p],
                           acc_h[i][j][q + p], hv[p], dgv[p], duv[p]);
        const size_t o = (size_t)s_rows[r] * F + c;
        store2(h + o, hv[0], hv[1], c + 1 < F);
        store2(du + o, duv[0], duv[1], c + 1 < F);
        if (kGate) store2(dg + o, dgv[0], dgv[1], c + 1 < F);
      }
}

// 2. dx of slot blockIdx.z over columns [n0, n0 + 64) of d: zeros into the
// dead rows among positions [p0, p0 + 128), then the live rows p0 .. p0 +
// 128 of the slot's list: dg Wg[e]^T + du Wu[e]^T, one sum over 2F.
template <int ACT>
__global__ void __launch_bounds__(kThreads, 2)
moe_bwd_input(const bf16* __restrict__ dg, const bf16* __restrict__ du,
          const bf16* __restrict__ wg, const bf16* __restrict__ wu,
          const int32_t* __restrict__ se, const int32_t* __restrict__ counts,
          const int32_t* __restrict__ index, bf16* __restrict__ dx, int S,
          int T, int d, int F, int E, int B, int aligned_flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_rows[kBM];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kParts = ACT == kSwiglu ? 2 : 1;   // (dg, Wg), (du, Wu)
  constexpr int kBK = kInputBK, kAK = Tile<kBK>::kAK;
  constexpr int kStage = kAK + Tile<kBK>::kNK;
  const int s = blockIdx.z, p0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = se[s];
  const bool expert = e >= 0 && e < E;
  const int Tb = T / B;
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int t = p0 + i / kBN, c = n0 + i % kBN;
    if (t < T && c < d && !(expert && row_live(counts, s, t, B, Tb)))
      dx[((size_t)s * T + t) * d + c] = __float2bfloat16(0.f);
  }
  const int n_live = expert ? index[S + s] : 0;
  if (p0 >= n_live) return;
  const int rows = min(kBM, n_live - p0);
  const int wm = warp >> 1, wn = warp & 1;
  const bool aligned = aligned_flag != 0;
  for (int r = tid; r < rows; r += kThreads)
    s_rows[r] = index[2 * S + E + 1 + index[s] + p0 + r];
  __syncthreads();

  const bf16* Wu = wu + (size_t)e * d * F;
  const bf16* W0 = kParts == 2 ? wg + (size_t)e * d * F : Wu;
  const bf16* G0 = kParts == 2 ? dg : du;
  const int nkf = (F + kBK - 1) / kBK;
  Acc acc;
  zero_acc(acc);
  // part 0: (dg, Wg) with a gate, else (du, Wu); part 1: (du, Wu)
  AlongRows<kBM, kBK> lg0, lg1;
  AlongRows<kBN, kBK> lw0, lw1;
  lg0.init([&](int r) {
    return r < rows ? G0 + (size_t)s_rows[r] * F : nullptr;
  }, F, G0);
  lw0.init([&](int r) {
    return n0 + r < d ? W0 + (size_t)(n0 + r) * F : nullptr;
  }, F, W0);
  if (kParts == 2) {
    lg1.init([&](int r) {
      return r < rows ? du + (size_t)s_rows[r] * F : nullptr;
    }, F, du);
    lw1.init([&](int r) {
      return n0 + r < d ? Wu + (size_t)(n0 + r) * F : nullptr;
    }, F, Wu);
  }
  auto load = [&](int st, int kt) {
    bf16* base = smem + st * kStage;
    const int k0 = (kt % nkf) * kBK;
    if (kParts == 1 || kt < nkf) {
      lg0.load(base, k0, aligned);
      lw0.load(base + kAK, k0, aligned);
    } else {
      lg1.load(base, k0, aligned);
      lw1.load(base + kAK, k0, aligned);
    }
  };
  auto compute = [&](int st) {
    const bf16* base = smem + st * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
      a_frags<false, kBK + kPad>(a, base, wm * 32, kk, lane);
      b_frags<true, kBK + kPad>(b, base + kAK, wn * 32, kk, lane);
      mma_tile(acc, a, b);
    }
  };
  pipeline<kInputStages>(kParts * nkf, load, compute);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int r = acc_row(wm, lane, i, q);
        const int c = n0 + acc_col(wn, lane, j, q);
        if (r < rows && c < d)
          store2(dx + (size_t)s_rows[r] * d + c, acc[i][j][q],
                 acc[i][j][q + 1], c + 1 < d);
      }
}

template <int NB>
struct Weight {
  using Tl = Tile<kWeightBK>;
  static constexpr int kStage = Tl::kKM + NB * Tl::kKN;
  static constexpr size_t kSmem = (size_t)kWeightStages * kStage *
                                  sizeof(bf16);
};

// 3./4. out_b[e] (M x N) = sum over weight row e's live rows of a[row]^T
// b_b[row], for one 128 x 64 tile; a: rows of M elements, b_b: rows of N.
template <int NB>
__global__ void __launch_bounds__(kThreads, 2)
moe_bwd_weight(const bf16* __restrict__ a, const bf16* __restrict__ b0,
           const bf16* __restrict__ b1, const int32_t* __restrict__ index,
           bf16* __restrict__ out0, bf16* __restrict__ out1, int S, int E,
           int M, int N, int aligned_flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kStage = Weight<NB>::kStage, kBK = kWeightBK;
  constexpr int kKM = Tile<kBK>::kKM, kKN = Tile<kBK>::kKN;
  const int e = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const bool aligned = aligned_flag != 0;
  const int32_t* exp_off = index + 2 * S;
  const int32_t* rows = index + 2 * S + E + 1 + exp_off[e];
  const int n_rows = exp_off[e + 1] - exp_off[e];
  Acc acc0, acc1;
  zero_acc(acc0);
  zero_acc(acc1);
  ListedRows<kBK, kBM> la;
  ListedRows<kBK, kBN> lb0, lb1;
  la.init(a, rows, n_rows, M, m0, M);
  lb0.init(b0, rows, n_rows, N, n0, N);
  if (NB == 2) lb1.init(b1, rows, n_rows, N, n0, N);
  auto load = [&](int st, int kt) {
    bf16* base = smem + st * kStage;
    const int k0 = kt * kBK;
    la.load(base, k0, a, aligned);
    lb0.load(base + kKM, k0, b0, aligned);
    if (NB == 2) lb1.load(base + kKM + kKN, k0, b1, aligned);
  };
  auto compute = [&](int st) {
    const bf16* base = smem + st * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], b[4][2];
      a_frags<true, kBM + kPad>(af, base, wm * 32, kk, lane);
      b_frags<false, kBN + kPad>(b, base + kKM, wn * 32, kk, lane);
      mma_tile(acc0, af, b);
      if (NB == 2) {
        b_frags<false, kBN + kPad>(b, base + kKM + kKN, wn * 32, kk, lane);
        mma_tile(acc1, af, b);
      }
    }
  };
  pipeline<kWeightStages>((n_rows + kBK - 1) / kBK, load, compute);

  const size_t off = (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int m = m0 + acc_row(wm, lane, i, q);
        const int n = n0 + acc_col(wn, lane, j, q);
        if (m < M && n < N) {
          const size_t o = off + (size_t)m * N + n;
          store2(out0 + o, acc0[i][j][q], acc0[i][j][q + 1], n + 1 < N);
          if (NB == 2)
            store2(out1 + o, acc1[i][j][q], acc1[i][j][q + 1], n + 1 < N);
        }
      }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA kernels over the same row lists
// ---------------------------------------------------------------------------

// h, dg, du of kFRows live rows of slot blockIdx.z, one column of F a thread.
template <int ACT>
__global__ void __launch_bounds__(kFThreads)
moe_bwd_hidden_f32(const float* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ wg, const float* __restrict__ wu,
               const float* __restrict__ wd, const int32_t* __restrict__ se,
               const int32_t* __restrict__ index, float* __restrict__ h,
               float* __restrict__ dg, float* __restrict__ du, int S, int d,
               int F, int E) {
  const int s = blockIdx.z, m0 = blockIdx.x * kFRows;
  const int f = blockIdx.y * kFThreads + threadIdx.x;
  const int e = se[s];
  const int n_live = index[S + s];
  if (e < 0 || e >= E || m0 >= n_live || f >= F) return;
  const int rows = min(kFRows, n_live - m0);
  const int32_t* list = index + 2 * S + E + 1 + index[s] + m0;
  const float* Wu = wu + (size_t)e * d * F + f;
  const float* Wg = (ACT == kSwiglu ? wg : wu) + (size_t)e * d * F + f;
  const float* Wd = wd + (size_t)e * F * d + (size_t)f * d;
  for (int r = 0; r < rows; ++r) {
    const float* xr = x + (size_t)list[r] * d;
    const float* dyr = dy + (size_t)list[r] * d;
    float g = 0.f, u = 0.f, dh = 0.f;
    for (int k = 0; k < d; ++k) {
      u = fmaf(xr[k], Wu[(size_t)k * F], u);
      if (ACT == kSwiglu) g = fmaf(xr[k], Wg[(size_t)k * F], g);
      dh = fmaf(dyr[k], Wd[k], dh);
    }
    float hv, dgv, duv;
    hidden_grad<ACT>(g, u, dh, hv, dgv, duv);
    const size_t o = (size_t)list[r] * F + f;
    h[o] = hv;
    du[o] = duv;
    if (ACT == kSwiglu) dg[o] = dgv;
  }
}

// dx of kFRows row positions of slot blockIdx.z, one column of d a thread;
// dead rows and slots without an expert get zeros.
template <int ACT>
__global__ void __launch_bounds__(kFThreads)
moe_bwd_input_f32(const float* __restrict__ dg, const float* __restrict__ du,
              const float* __restrict__ wg, const float* __restrict__ wu,
              const int32_t* __restrict__ se,
              const int32_t* __restrict__ counts, float* __restrict__ dx,
              int T, int d, int F, int E, int B) {
  const int s = blockIdx.z, t0 = blockIdx.x * kFRows;
  const int c = blockIdx.y * kFThreads + threadIdx.x;
  if (c >= d) return;
  const int e = se[s];
  const bool expert = e >= 0 && e < E;
  const int Tb = T / B;
  for (int t = t0; t < min(T, t0 + kFRows); ++t) {
    const size_t row = (size_t)s * T + t;
    float acc = 0.f;
    if (expert && row_live(counts, s, t, B, Tb)) {
      const float* Wu = wu + (size_t)e * d * F + (size_t)c * F;
      if (ACT == kSwiglu) {
        const float* Wg = wg + (size_t)e * d * F + (size_t)c * F;
        for (int k = 0; k < F; ++k) acc = fmaf(dg[row * F + k], Wg[k], acc);
      }
      for (int k = 0; k < F; ++k) acc = fmaf(du[row * F + k], Wu[k], acc);
    }
    dx[row * d + c] = acc;
  }
}

// out_b[e][m][n] = sum over weight row e's rows of a[row][m] b_b[row][n];
// one column n a thread, kFRows values of m.
template <int NB>
__global__ void __launch_bounds__(kFThreads)
moe_bwd_weight_f32(const float* __restrict__ a, const float* __restrict__ b0,
               const float* __restrict__ b1, const int32_t* __restrict__ index,
               float* __restrict__ out0, float* __restrict__ out1, int S,
               int E, int M, int N) {
  const int e = blockIdx.z, m0 = blockIdx.y * kFRows;
  const int n = blockIdx.x * kFThreads + threadIdx.x;
  if (n >= N) return;
  const int32_t* exp_off = index + 2 * S;
  const int32_t* rows = index + 2 * S + E + 1 + exp_off[e];
  const int n_rows = exp_off[e + 1] - exp_off[e];
  float c0[kFRows], c1[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) c0[i] = c1[i] = 0.f;
  for (int j = 0; j < n_rows; ++j) {
    const size_t row = rows[j];
    const float v0 = b0[row * N + n];
    const float v1 = NB == 2 ? b1[row * N + n] : 0.f;
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      if (m0 + i < M) {
        const float av = a[row * M + m0 + i];
        c0[i] = fmaf(av, v0, c0[i]);
        if (NB == 2) c1[i] = fmaf(av, v1, c1[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    if (m0 + i < M) {
      out0[(size_t)e * M * N + (size_t)(m0 + i) * N + n] = c0[i];
      if (NB == 2) out1[(size_t)e * M * N + (size_t)(m0 + i) * N + n] = c1[i];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = err == cudaSuccess;
  return err;
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

// One call's tensors and shapes. Without a gate, wg, dg and dwg alias wu,
// du and dwu (the kernels then read and write only the latter).
struct Args {
  const void *x, *wg, *wu, *wd, *dy;
  const int32_t *se, *counts, *index;
  void *h, *dg, *du, *dx, *dwg, *dwu, *dwd;
  int S, T, d, F, E, B, aligned;
  cudaStream_t st;
};

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* out(void* p) { return static_cast<T*>(p); }

template <int ACT>
cudaError_t run_bf16(const Args& a) {
  constexpr int kGU = ACT == kSwiglu ? 2 : 1;
  constexpr size_t kInputSmem = (size_t)kInputStages *
      (Tile<kInputBK>::kAK + Tile<kInputBK>::kNK) * sizeof(bf16);
  static bool attr[4] = {false, false, false, false};
  cudaError_t err;
  if ((err = set_smem(moe_bwd_hidden<ACT>, Hidden<ACT>::kSmem, attr[0])) ||
      (err = set_smem(moe_bwd_input<ACT>, kInputSmem, attr[1])) ||
      (err = set_smem(moe_bwd_weight<kGU>, Weight<kGU>::kSmem, attr[2])) ||
      (err = set_smem(moe_bwd_weight<1>, Weight<1>::kSmem, attr[3])))
    return err;
  const int S = a.S, T = a.T, d = a.d, F = a.F, E = a.E;
  moe_bwd_hidden<ACT><<<dim3(cdiv(T, kBM), cdiv(F, kBN), S), kThreads,
                        Hidden<ACT>::kSmem, a.st>>>(
      in<bf16>(a.x), in<bf16>(a.dy), in<bf16>(a.wg), in<bf16>(a.wu),
      in<bf16>(a.wd), a.se, a.index, out<bf16>(a.h), out<bf16>(a.dg),
      out<bf16>(a.du), S, d, F, E, a.aligned);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_input<ACT><<<dim3(cdiv(T, kBM), cdiv(d, kBN), S), kThreads,
                       kInputSmem, a.st>>>(
      out<bf16>(a.dg), out<bf16>(a.du), in<bf16>(a.wg), in<bf16>(a.wu), a.se,
      a.counts, a.index, out<bf16>(a.dx), S, T, d, F, E, a.B, a.aligned);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_weight<kGU><<<dim3(cdiv(d, kBM), cdiv(F, kBN), E), kThreads,
                        Weight<kGU>::kSmem, a.st>>>(
      in<bf16>(a.x), out<bf16>(a.dg), out<bf16>(a.du), a.index,
      out<bf16>(a.dwg), out<bf16>(a.dwu), S, E, d, F, a.aligned);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_weight<1><<<dim3(cdiv(F, kBM), cdiv(d, kBN), E), kThreads,
                      Weight<1>::kSmem, a.st>>>(
      out<bf16>(a.h), in<bf16>(a.dy), in<bf16>(a.dy), a.index,
      out<bf16>(a.dwd), out<bf16>(a.dwd), S, E, F, d, a.aligned);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t run_f32(const Args& a) {
  constexpr int kGU = ACT == kSwiglu ? 2 : 1;
  const int S = a.S, T = a.T, d = a.d, F = a.F, E = a.E;
  cudaError_t err;
  moe_bwd_hidden_f32<ACT>
      <<<dim3(cdiv(T, kFRows), cdiv(F, kFThreads), S), kFThreads, 0, a.st>>>(
          in<float>(a.x), in<float>(a.dy), in<float>(a.wg), in<float>(a.wu),
          in<float>(a.wd), a.se, a.index, out<float>(a.h), out<float>(a.dg),
          out<float>(a.du), S, d, F, E);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_input_f32<ACT>
      <<<dim3(cdiv(T, kFRows), cdiv(d, kFThreads), S), kFThreads, 0, a.st>>>(
          out<float>(a.dg), out<float>(a.du), in<float>(a.wg), in<float>(a.wu),
          a.se, a.counts, out<float>(a.dx), T, d, F, E, a.B);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_weight_f32<kGU>
      <<<dim3(cdiv(F, kFThreads), cdiv(d, kFRows), E), kFThreads, 0, a.st>>>(
          in<float>(a.x), out<float>(a.dg), out<float>(a.du), a.index,
          out<float>(a.dwg), out<float>(a.dwu), S, E, d, F);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_weight_f32<1>
      <<<dim3(cdiv(d, kFThreads), cdiv(F, kFRows), E), kFThreads, 0, a.st>>>(
          out<float>(a.h), in<float>(a.dy), in<float>(a.dy), a.index,
          out<float>(a.dwd), out<float>(a.dwd), S, E, F, d);
  return cudaGetLastError();
}

}  // namespace

// x, dy: (S, T, d); w_gate, w_up: (E, d, F) (w_gate read for swiglu only);
// w_down: (E, F, d); all of one dtype (0 = float32, 1 = bfloat16);
// slot_experts: (S,) int32; row_counts: (S, B) int32, T % B == 0, or null
// (every row live); h, dg, du: (S, T, F) scratch of x's dtype (dg unused
// unless swiglu); index: int32 scratch of 2 S + E + 1 + S T; dx: (S, T, d);
// dw_gate (swiglu only), dw_up: (E, d, F); dw_down: (E, F, d). activation:
// 0 = swiglu, 1 = gelu, 2 = relu. aligned = 1 when d and F are multiples of
// 8 and every pointer is 16-byte aligned (bf16 tiles then load with
// cp.async). Returns the first launch error (0 = all five launched).
extern "C" int moe_gemm_bwd(const void* x, const void* w_gate,
                            const void* w_up, const void* w_down,
                            const void* slot_experts, const void* row_counts,
                            const void* dy, void* h, void* dg, void* du,
                            void* index, void* dx, void* dw_gate, void* dw_up,
                            void* dw_down, int S, int T, int d, int F, int E,
                            int B, int activation, int dtype, int aligned,
                            void* stream) {
  if (S <= 0 || T <= 0 || d <= 0 || F <= 0 || E <= 0 || S > 65535 ||
      E > 65535 || B <= 0 || T % B != 0 || activation < 0 || activation > 2 ||
      (long long)S * T >= INT_MAX || cdiv(F, kBN) > 65535 ||
      cdiv(d, kBN) > 65535 || cdiv(d, kFRows) > 65535 ||
      cdiv(F, kFRows) > 65535)
    return cudaErrorInvalidValue;
  const bool gate = activation == kSwiglu;
  const Args a{x, gate ? w_gate : w_up, w_up, w_down, dy,
               static_cast<const int32_t*>(slot_experts),
               static_cast<const int32_t*>(row_counts),
               static_cast<const int32_t*>(index), h, gate ? dg : du, du, dx,
               gate ? dw_gate : dw_up, dw_up, dw_down, S, T, d, F, E, B,
               aligned, static_cast<cudaStream_t>(stream)};
  moe_bwd_rows<<<1, kPrepThreads, 0, a.st>>>(
      a.se, a.counts, static_cast<int32_t*>(index), S, T, E, B);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dtype == 1)
    return activation == kSwiglu ? run_bf16<kSwiglu>(a)
           : activation == kGelu ? run_bf16<kGelu>(a)
                                 : run_bf16<kRelu>(a);
  if (dtype == 0)
    return activation == kSwiglu ? run_f32<kSwiglu>(a)
           : activation == kGelu ? run_f32<kGelu>(a)
                                 : run_f32<kRelu>(a);
  return cudaErrorInvalidValue;
}
