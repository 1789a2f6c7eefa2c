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
// weights, activations and gradients, 1.7 ms: bound by operations. A real
// step's layer (~1534 live rows) is bound by the 2.8 GB of weight
// gradients it writes.
//
// Design. The live rows are packed per weight row first, so that every
// product is a dense grouped GEMM over contiguous rows that TMA can load.
// Seven launches:
//  0. moe_bwd_rows (one CTA): for each weight row e, a segment of packed
//     rows holding the live rows of every slot that names e (slots
//     ascending, then rows), padded with zero rows to a multiple of kTile;
//     the list packed row -> s * T + t (-1 for padding), each slot's place
//     in it, and the 128-row tiles of the segments. The host reads no
//     count: the scratch is sized for S T + E (kTile - 1) rows.
//  1. moe_bwd_pack: packed x and dy (16-byte copies, zeros in the
//     padding), and zeros into dx's dead rows.
//  2. moe_bwd_dh: per (128 packed rows of one expert, 256 columns of F),
//     dh = dy @ Wd^T over d (both operands K-major), kept in fp32.
//  3. moe_bwd_hidden: per (128 packed rows, 128 columns of F), g and u
//     (x @ Wg / Wu, the weights MN-major as in the forward) over d, then
//     h, dg, du from g, u and dh in x's dtype into packed (P, F) scratch.
//     dh has its own pass because three 64 x 128 fp32 accumulators (192
//     registers a thread) left room for two 64-deep stages of 80 KB: on an
//     H100 the fused kernel ran at 315 TFLOP/s (341 with 32-deep stages),
//     the two passes at the other products' rate for 0.5 GB of fp32 dh
//     traffic at the train step's layer.
//  4. moe_bwd_input: per (128 packed rows, 256 columns of d), dx = [dg du]
//     @ [Wg; Wu]^T as one K = 2F loop (both operands K-major), scattered
//     to each packed row's (s, t).
//  5. moe_bwd_weight_gu / 6. moe_bwd_weight_down: persistent, one CTA an
//     SM walking (expert, m, n) tiles expert by expert: dWg[e] = X_e^T
//     dG_e and dWu[e] = X_e^T dU_e (sharing the A tile), dWd[e] = H_e^T
//     dY_e, K the expert's padded segment; A is the packed rows read
//     transposed (MN-major), B MN-major. The producer streams the next
//     tile's stages while the consumers store the last one. An expert
//     with no live row writes zeros and reads nothing.
// Products 2-6 share one shape: 384 threads, a producer warp issuing
// 64-deep TMA boxes (128-byte swizzle; past the end zero-filled) into a
// ring of full / empty mbarriers, and two consumer warpgroups of 64 rows
// issuing wgmma (bf16 in, fp32 out), one group in flight; setmaxnreg gives
// the producer's registers to the consumers. Epilogues store 16 bytes a
// thread (a transpose inside each quad of lanes; dh 8). One expert's slots
// share one weight stream. No atomics: each output element is written by
// one CTA, its sums in a fixed order, so repeated calls are bit-identical.
// fp32 inputs (used only to check the arithmetic), and bf16 rows that are
// not whole 16-byte chunks (d or F not a multiple of 8, or a pointer not
// 16-byte aligned; test shapes only), take FMA kernels over the same row
// lists, five launches; the host picks the path from shapes alone.
// The TMA / wgmma / mbarrier pieces are in hopper.cuh, shared with
// moe_gemm.cu.
// On an H100 SXM (700 W; chip_smoke.py, PERF.md): 8.5-8.8 ms at the train
// step's layer (device 8.2-8.5, ~460 TFLOP/s, 0.44-0.46 of the bound; each
// GEMM at 0.43-0.55 of its own), 4.2 ms at a real EP step's layer (1534
// live rows; 0.38 of its bytes bound), 1.1-1.2 ms at llama-moe's F 688 and
// 1.5-1.6 ms at switch's relu layer, where 64-row padding of ~16-row
// segments quadruples dh and hidden.
// Not done yet: programmatic dependent launch between the seven launches,
// weight tiles multicast across a cluster, ping-pong consumers for the
// weight gradients' epilogues.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;              // segments pad to this many rows
constexpr int kTM = 128;               // packed rows a hidden / input CTA
constexpr int kHN = 128;               // F columns a hidden CTA
constexpr int kRN = 256;               // columns a dh / input CTA
constexpr int kWM = 128;               // weight-gradient rows a tile
constexpr int kWThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRingBytes = 200 * 1024; // each product kernel's ring fits this
constexpr int kPrepThreads = 1024;
constexpr int kPackThreads = 256;      // 8 warps, a row each
constexpr int kFThreads = 128;         // FMA kernels: columns per CTA
constexpr int kFRows = 8;              // FMA kernels: rows per thread

enum Act { kSwiglu = 0, kGelu = 1, kRelu = 2 };

__host__ __device__ inline int pack_rows(int S, int T, int E) {
  return S * T + E * (kTile - 1);
}
__host__ __device__ inline int max_tiles(int P) {
  return (P + kTile - 1) / kTile;
}

// The int32 index scratch, in this order (kernels/moe_gemm.py::
// split_bwd_index reads it): slot_start (S), each slot's first packed row;
// slot_n (S), its live rows; seg_off (E + 1), each weight row's first
// packed row (seg_off[E]: the packed rows in all); seg_n (E), its live
// rows; n_tiles (1); tile_row0, tile_rows, tile_e (max_tiles each), each
// 128-row tile's first packed row, its rows (64 or 128) and its weight
// row; packed (pack_rows), s * T + t of each packed row, -1 for padding.
struct Index {
  int32_t *slot_start, *slot_n, *seg_off, *seg_n, *n_tiles, *tile_row0,
      *tile_rows, *tile_e, *packed;
  __host__ __device__ Index(const int32_t* base, int S, int T, int E) {
    int32_t* p = const_cast<int32_t*>(base);
    const int tm = max_tiles(pack_rows(S, T, E));
    slot_start = p;
    slot_n = slot_start + S;
    seg_off = slot_n + S;
    seg_n = seg_off + E + 1;
    n_tiles = seg_n + E;
    tile_row0 = n_tiles + 1;
    tile_rows = tile_row0 + tm;
    tile_e = tile_rows + tm;
    packed = tile_e + tm;
  }
};

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
// 0. the packed layout
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPrepThreads)
moe_bwd_rows(const int32_t* __restrict__ se, const int32_t* __restrict__ counts,
             int32_t* __restrict__ index, int S, int T, int E, int B) {
  const Index ix(index, S, T, E);
  const int Tb = T / B;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int e = se[s];
    int n = 0;
    if (e >= 0 && e < E)
      for (int b = 0; b < B; ++b) n += block_live(counts, s, b, B, Tb);
    ix.slot_n[s] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int e = 0; e < E; ++e) ix.seg_n[e] = 0;
    for (int s = 0; s < S; ++s) {
      const int e = se[s];
      if (e >= 0 && e < E) ix.seg_n[e] += ix.slot_n[s];
    }
    int off = 0, nt = 0;
    for (int e = 0; e < E; ++e) {
      const int len = (ix.seg_n[e] + kTile - 1) / kTile * kTile;
      ix.seg_off[e] = off;
      for (int r = 0; r < len; r += kTM) {
        ix.tile_row0[nt] = off + r;
        ix.tile_rows[nt] = min(kTM, len - r);
        ix.tile_e[nt] = e;
        ++nt;
      }
      off += len;
    }
    ix.seg_off[E] = off;
    *ix.n_tiles = nt;
  }
  __syncthreads();
  // each slot's place: its expert's segment, after the earlier slots of it
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int e = se[s];
    int at = 0;
    if (e >= 0 && e < E) {
      at = ix.seg_off[e];
      for (int s2 = 0; s2 < s; ++s2) at += se[s2] == e ? ix.slot_n[s2] : 0;
    }
    ix.slot_start[s] = at;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int s = warp; s < S; s += warps) {
    if (ix.slot_n[s] == 0) continue;
    int at = ix.slot_start[s];
    for (int b = 0; b < B; ++b) {
      const int c = block_live(counts, s, b, B, Tb);
      for (int i = lane; i < c; i += 32) ix.packed[at + i] = s * T + b * Tb + i;
      at += c;
    }
  }
  for (int e = warp; e < E; e += warps)
    for (int p = ix.seg_off[e] + ix.seg_n[e] + lane; p < ix.seg_off[e + 1];
         p += 32)
      ix.packed[p] = -1;
}

// 1. Packed x and dy, a warp a row (blockIdx.y 0), and zeros into dx's dead
// rows (blockIdx.y 1). d is a multiple of 8 and every pointer 16-byte
// aligned here.
__global__ void __launch_bounds__(kPackThreads)
moe_bwd_pack(const bf16* __restrict__ x, const bf16* __restrict__ dy,
             const int32_t* __restrict__ se, const int32_t* __restrict__ counts,
             const int32_t* __restrict__ index, bf16* __restrict__ xp,
             bf16* __restrict__ dyp, bf16* __restrict__ dx, int S, int T,
             int d, int E, int B) {
  const Index ix(index, S, T, E);
  const int row = (blockIdx.x * kPackThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, chunks = d / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (blockIdx.y == 0) {
    if (row >= ix.seg_off[E]) return;
    const int src = ix.packed[row];
    uint4* xo = reinterpret_cast<uint4*>(xp + (size_t)row * d);
    uint4* dyo = reinterpret_cast<uint4*>(dyp + (size_t)row * d);
    if (src < 0) {
      for (int c = lane; c < chunks; c += 32) xo[c] = dyo[c] = zero;
      return;
    }
    const uint4* xs = reinterpret_cast<const uint4*>(x + (size_t)src * d);
    const uint4* dys = reinterpret_cast<const uint4*>(dy + (size_t)src * d);
    for (int c = lane; c < chunks; c += 32) {
      xo[c] = xs[c];
      dyo[c] = dys[c];
    }
    return;
  }
  if (row >= S * T) return;
  const int s = row / T, t = row % T, e = se[s];
  if (e >= 0 && e < E && row_live(counts, s, t, B, T / B)) return;
  uint4* o = reinterpret_cast<uint4*>(dx + (size_t)row * d);
  for (int c = lane; c < chunks; c += 32) o[c] = zero;
}

// ---------------------------------------------------------------------------
// products 2-5: TMA ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

// A ring of kStages stages of STAGE bytes, then its full and empty barriers,
// 1024-byte aligned for the 128-byte swizzle.
template <int STAGE>
struct Ring {
  static constexpr int kStages = kRingBytes / STAGE < 6 ? kRingBytes / STAGE
                                                        : 6;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * STAGE +
                                  2 * kStages * sizeof(uint64_t);
  unsigned char* base;
  uint64_t *full, *empty;
  __device__ explicit Ring(unsigned char* raw) {
    base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(base + kStages * STAGE);
    empty = full + kStages;
  }
  __device__ unsigned char* stage(int it) const {
    return base + (it % kStages) * STAGE;
  }
  // one arrival a consumer warpgroup empties a stage; the producer's
  // expect_tx fills it
  __device__ void init(int consumers) const {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the producer's wait for ring step it, then its byte count
  __device__ unsigned char* fill(int it) const {
    const int st = it % kStages;
    mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
    mbar_expect_tx(&full[st], STAGE);
    return base + st * STAGE;
  }
  __device__ void wait_full(int it) const {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
  }
  __device__ void release(int it, int tid) const {
    if (tid % 128 == 0) mbar_arrive(&empty[it % kStages]);
  }
};

template <int N, int R>
__device__ __forceinline__ void zero_acc(float (&acc)[R][N / 2]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.f;
}

// x 128 x 64 packed rows of dy, dg or du, then 256 weight rows x 64: 48
// KB, 4 stages
using RowsRing = Ring<kTM * 128 + kRN * 128>;

// out = sum over PARTS of A_p @ B_p[e]^T for one 128-row packed tile over
// columns [n0, n0 + 256): A_p (P, K) packed rows, B_p (E, N, K) weight rows,
// both K-major; part p's k runs over [0, K) before part p + 1's. store(row
// in the tile, column in the tile, v0, v1) takes two fp32 columns.
template <int PARTS, class Store>
__device__ __forceinline__ void rows_gemm(const CUtensorMap& tm_a0,
                                          const CUtensorMap& tm_a1,
                                          const CUtensorMap& tm_b0,
                                          const CUtensorMap& tm_b1,
                                          const Index& ix, int K, Store store) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RowsRing ring(smem_raw);
  const int tile = blockIdx.x;
  if (tile >= *ix.n_tiles) return;
  const int row0 = ix.tile_row0[tile], e = ix.tile_e[tile];
  const int consumers = ix.tile_rows[tile] > 64 ? 2 : 1;
  const int n0 = blockIdx.y * kRN, tid = threadIdx.x;
  if (tid == 0) ring.init(consumers);
  __syncthreads();
  const int nkp = (K + 63) / 64, nk = PARTS * nkp;
  const int wg = tid / 128;
  if (wg == 0) {                       // producer: one thread issues TMA
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        unsigned char* st = ring.fill(kt);
        uint64_t* bar = &ring.full[kt % RowsRing::kStages];
        const bool first = PARTS == 1 || kt < nkp;
        const int k0 = (kt % nkp) * 64;
        tma_load(st, first ? &tm_a0 : &tm_a1, bar, k0, row0, 0);
        tma_load(st + kTM * 128, first ? &tm_b0 : &tm_b1, bar, k0, n0, e);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;               // rows 64 cw .. 64 cw + 63 of the tile
  if (cw >= consumers) return;
  float acc[1][kRN / 2];
  zero_acc<kRN>(acc);
  for (int kt = 0; kt < nk; ++kt) {
    ring.wait_full(kt);
    const unsigned char* st = ring.stage(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<kRN, 0, 0>(acc[0], kmajor_desc(st + cw * 64 * 128, kk),
                       kmajor_desc(st + kTM * 128, kk));
    wgmma_commit();
    wgmma_wait<1>();                   // the previous stage's products ended
    if (kt > 0) ring.release(kt - 1, tid);
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  store(row0 + cw * 64, n0, acc[0]);
}

// 2. dh = dy @ Wd[e]^T of one 128-row packed tile over F columns [n0, n0 +
// 256), kept in fp32 (packed (P, F) scratch) for the hidden epilogue.
__global__ void __launch_bounds__(kWThreads, 1)
moe_bwd_dh(const __grid_constant__ CUtensorMap tm_dy,
           const __grid_constant__ CUtensorMap tm_wd,
           const int32_t* __restrict__ index, float* __restrict__ dhp, int S,
           int T, int d, int F, int E) {
  const Index ix(index, S, T, E);
  rows_gemm<1>(tm_dy, tm_dy, tm_wd, tm_wd, ix, d,
               [&](int row0, int n0, const float (&acc)[kRN / 2]) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* o = dhp + (size_t)(row0 + r0 + 8 * half) * F + n0;
#pragma unroll
      for (int j = 0; j < kRN / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        if (n0 + c < F)
          *reinterpret_cast<float2*>(o + c) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  });
}

template <int ACT>
struct Hidden {
  static constexpr int kNB = ACT == kSwiglu ? 2 : 1;   // (Wg,) Wu
  // x 128 x 64, then Wu (and Wg) as two 64 x 64 boxes: 48 KB with a gate
  // (4 stages), 32 KB without (6)
  using Rg = Ring<kTM * 128 + kNB * 2 * kBox>;
};

// 3. h, dg and du of one 128-row packed tile over F columns [n0, n0 +
// 128): g and u (x @ Wg / Wu[e], the weights MN-major) over d, then the
// epilogue with dh from moe_bwd_dh.
template <int ACT>
__global__ void __launch_bounds__(kWThreads, 1)
moe_bwd_hidden(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_wg,
               const __grid_constant__ CUtensorMap tm_wu,
               const int32_t* __restrict__ index,
               const float* __restrict__ dhp, bf16* __restrict__ hp,
               bf16* __restrict__ dgp, bf16* __restrict__ dup, int S, int T,
               int d, int F, int E) {
  constexpr bool kGate = ACT == kSwiglu;
  constexpr int kNB = Hidden<ACT>::kNB;
  using Rg = typename Hidden<ACT>::Rg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Rg ring(smem_raw);
  const Index ix(index, S, T, E);
  const int tile = blockIdx.x;
  if (tile >= *ix.n_tiles) return;
  const int row0 = ix.tile_row0[tile], e = ix.tile_e[tile];
  const int consumers = ix.tile_rows[tile] > 64 ? 2 : 1;
  const int n0 = blockIdx.y * kHN, tid = threadIdx.x;
  if (tid == 0) ring.init(consumers);
  __syncthreads();
  const int nk = (d + 63) / 64;
  const int wg = tid / 128;
  if (wg == 0) {                       // producer: one thread issues TMA
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        unsigned char* st = ring.fill(kt);
        uint64_t* bar = &ring.full[kt % Rg::kStages];
        tma_load(st, &tm_x, bar, kt * 64, row0, 0);
#pragma unroll
        for (int b = 0; b < kNB; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load(st + kTM * 128 + (2 * b + h) * kBox, b ? &tm_wg : &tm_wu,
                     bar, n0 + 64 * h, kt * 64, e);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;               // rows 64 cw .. 64 cw + 63 of the tile
  if (cw >= consumers) return;
  float acc[kNB][64];                  // u (, g)
  zero_acc<128>(acc);
  for (int kt = 0; kt < nk; ++kt) {
    ring.wait_full(kt);
    const unsigned char* st = ring.stage(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = kmajor_desc(st + cw * 64 * 128, kk);
#pragma unroll
      for (int b = 0; b < kNB; ++b)
        wgmma<128, 0, 1>(acc[b], da,
                         mnmajor_desc(st + kTM * 128 + 2 * b * kBox, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();                   // the previous stage's products ended
    if (kt > 0) ring.release(kt - 1, tid);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < kNB; ++b) fence_regs(acc[b]);

  // in place: acc[0] <- du, acc[1] <- dg; h into a third array as it goes
  const int lane = tid & 31;
  const size_t r0 = (size_t)row0 + cw * 64 + ((tid & 127) >> 5) * 16 +
                    (lane >> 2);
  float hv[64];
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int c = n0 + 8 * (i / 4) + 2 * (lane & 3);
    float2 dh = make_float2(0.f, 0.f);
    if (c < F)
      dh = *reinterpret_cast<const float2*>(
          dhp + (r0 + 8 * ((i / 2) % 2)) * F + c);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float dg, du;
      hidden_grad<ACT>(acc[kNB - 1][i + q], acc[0][i + q], q ? dh.y : dh.x,
                       hv[i + q], dg, du);
      acc[0][i + q] = du;
      if constexpr (kGate) acc[1][i + q] = dg;
    }
  }
  const size_t base = (size_t)row0 + cw * 64;
  auto put = [&](bf16* out) {
    return [=](int r, int c, uint4 v) {
      if (n0 + c < F)
        *reinterpret_cast<uint4*>(out + (base + r) * F + n0 + c) = v;
    };
  };
  store_acc16<128>(hv, tid, put(hp));
  store_acc16<128>(acc[0], tid, put(dup));
  if constexpr (kGate) store_acc16<128>(acc[1], tid, put(dgp));
}

// 4. dx of one 128-row packed tile over d columns [n0, n0 + 256): the sum
// over k in [0, F) of dg Wg^T (with a gate), then of du Wu^T, scattered to
// each packed row's (s, t).
template <int ACT>
__global__ void __launch_bounds__(kWThreads, 1)
moe_bwd_input(const __grid_constant__ CUtensorMap tm_dg,
              const __grid_constant__ CUtensorMap tm_du,
              const __grid_constant__ CUtensorMap tm_wg,
              const __grid_constant__ CUtensorMap tm_wu,
              const int32_t* __restrict__ index, bf16* __restrict__ dx,
              int S, int T, int d, int F, int E) {
  const Index ix(index, S, T, E);
  constexpr int kParts = ACT == kSwiglu ? 2 : 1;
  rows_gemm<kParts>(kParts == 2 ? tm_dg : tm_du, tm_du,
                    kParts == 2 ? tm_wg : tm_wu, tm_wu, ix, F,
                    [&](int row0, int n0, const float (&acc)[kRN / 2]) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int dst[2] = {ix.packed[row0 + r0], ix.packed[row0 + r0 + 8]};
    store_acc16<kRN>(acc, tid, [&](int r, int c, uint4 v) {
      const int row = dst[r != r0];
      if (row >= 0 && n0 + c < d)
        *reinterpret_cast<uint4*>(dx + (size_t)row * d + n0 + c) = v;
    });
  });
}

// A (two 64-wide boxes of 64 packed rows), then NB B tiles of BN / 64 boxes
template <int NB, int BN>
using WeightRing = Ring<2 * kBox + NB * (BN / 64) * kBox>;

// 4./5. out_b[e] (M x N) = A_e^T B_b,e over weight row e's padded segment,
// for every (e, 128-row m tile, BN-column n tile), CTA blockIdx.x taking
// every gridDim.x-th tile. A: packed (P, M); B_b: packed (P, N).
template <int NB, int BN>
__device__ __forceinline__ void weight_grad(const CUtensorMap& tm_a,
                                            const CUtensorMap& tm_b0,
                                            const CUtensorMap& tm_b1,
                                            const int32_t* __restrict__ index,
                                            bf16* __restrict__ out0,
                                            bf16* __restrict__ out1, int S,
                                            int T, int E, int M, int N) {
  using Rg = WeightRing<NB, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Rg ring(smem_raw);
  const Index ix(index, S, T, E);
  const int tid = threadIdx.x;
  if (tid == 0) ring.init(2);
  __syncthreads();
  const int mt = (M + kWM - 1) / kWM, nt = (N + BN - 1) / BN;
  const int per_e = mt * nt, total = E * per_e;
  const int wg = tid / 128;
  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int e = t / per_e, m0 = (t % per_e) / nt * kWM;
        const int n0 = (t % nt) * BN;
        const int seg = ix.seg_off[e], nk = (ix.seg_n[e] + 63) / 64;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          unsigned char* st = ring.fill(it);
          uint64_t* bar = &ring.full[it % Rg::kStages];
          const int k0 = seg + kt * 64;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load(st + h * kBox, &tm_a, bar, m0 + 64 * h, k0, 0);
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(st + (2 + b * (BN / 64) + j) * kBox, b ? &tm_b1 : &tm_b0,
                       bar, n0 + 64 * j, k0, 0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;               // rows 64 cw .. 64 cw + 63 of the tile
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int e = t / per_e, m0 = (t % per_e) / nt * kWM;
    const int n0 = (t % nt) * BN;
    const int nk = (ix.seg_n[e] + 63) / 64;
    float acc[NB][BN / 2];
    zero_acc<BN>(acc);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      ring.wait_full(it);
      const unsigned char* st = ring.stage(it);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = mnmajor_desc(st + cw * kBox, kk);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          wgmma<BN, 1, 1>(acc[b], da,
                          mnmajor_desc(st + (2 + b * (BN / 64)) * kBox, kk));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) ring.release(it - 1, tid);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (nk > 0) ring.release(it - 1, tid);  // the next tile's loads go on
    const size_t m_row = (size_t)m0 + cw * 64;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      bf16* out = (b ? out1 : out0) + (size_t)e * M * N;
      store_acc16<BN>(acc[b], tid, [&](int r, int c, uint4 v) {
        if (m_row + r < (size_t)M && n0 + c < N)
          *reinterpret_cast<uint4*>(out + (m_row + r) * N + n0 + c) = v;
      });
    }
  }
}

// dWg and dWu (swiglu: NB 2, BN 128) or dWu alone (NB 1, BN 256)
template <int NB, int BN>
__global__ void __launch_bounds__(kWThreads, 1)
moe_bwd_weight_gu(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_b0,
                  const __grid_constant__ CUtensorMap tm_b1,
                  const int32_t* __restrict__ index, bf16* __restrict__ out0,
                  bf16* __restrict__ out1, int S, int T, int E, int d, int F) {
  weight_grad<NB, BN>(tm_x, tm_b0, tm_b1, index, out0, out1, S, T, E, d, F);
}

__global__ void __launch_bounds__(kWThreads, 1)
moe_bwd_weight_down(const __grid_constant__ CUtensorMap tm_h,
                    const __grid_constant__ CUtensorMap tm_dy,
                    const int32_t* __restrict__ index, bf16* __restrict__ out,
                    int S, int T, int E, int d, int F) {
  weight_grad<1, 256>(tm_h, tm_dy, tm_dy, index, out, out, S, T, E, F, d);
}

// ---------------------------------------------------------------------------
// fp32, and bf16 rows that are not whole 16-byte chunks: FMA kernels over
// the same row lists, h, dg and du at each row's s * T + t
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename V>
__device__ __forceinline__ V from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// h, dg, du of kFRows live rows of slot blockIdx.z, one column of F a thread.
template <typename V, int ACT>
__global__ void __launch_bounds__(kFThreads)
moe_bwd_hidden_fma(const V* __restrict__ x, const V* __restrict__ dy,
                   const V* __restrict__ wg, const V* __restrict__ wu,
                   const V* __restrict__ wd, const int32_t* __restrict__ se,
                   const int32_t* __restrict__ index, V* __restrict__ h,
                   V* __restrict__ dg, V* __restrict__ du, int S, int T,
                   int d, int F, int E) {
  const Index ix(index, S, T, E);
  const int s = blockIdx.z, m0 = blockIdx.x * kFRows;
  const int f = blockIdx.y * kFThreads + threadIdx.x;
  const int e = se[s];
  const int n_live = ix.slot_n[s];
  if (e < 0 || e >= E || m0 >= n_live || f >= F) return;
  const int rows = min(kFRows, n_live - m0);
  const int32_t* list = ix.packed + ix.slot_start[s] + m0;
  const V* Wu = wu + (size_t)e * d * F + f;
  const V* Wg = (ACT == kSwiglu ? wg : wu) + (size_t)e * d * F + f;
  const V* Wd = wd + (size_t)e * F * d + (size_t)f * d;
  for (int r = 0; r < rows; ++r) {
    const V* xr = x + (size_t)list[r] * d;
    const V* dyr = dy + (size_t)list[r] * d;
    float g = 0.f, u = 0.f, dh = 0.f;
    for (int k = 0; k < d; ++k) {
      u = fmaf(to_f(xr[k]), to_f(Wu[(size_t)k * F]), u);
      if (ACT == kSwiglu) g = fmaf(to_f(xr[k]), to_f(Wg[(size_t)k * F]), g);
      dh = fmaf(to_f(dyr[k]), to_f(Wd[k]), dh);
    }
    float hv, dgv, duv;
    hidden_grad<ACT>(g, u, dh, hv, dgv, duv);
    const size_t o = (size_t)list[r] * F + f;
    h[o] = from_f<V>(hv);
    du[o] = from_f<V>(duv);
    if (ACT == kSwiglu) dg[o] = from_f<V>(dgv);
  }
}

// dx of kFRows row positions of slot blockIdx.z, one column of d a thread;
// dead rows and slots without an expert get zeros.
template <typename V, int ACT>
__global__ void __launch_bounds__(kFThreads)
moe_bwd_input_fma(const V* __restrict__ dg, const V* __restrict__ du,
                  const V* __restrict__ wg, const V* __restrict__ wu,
                  const int32_t* __restrict__ se,
                  const int32_t* __restrict__ counts, V* __restrict__ dx,
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
      const V* Wu = wu + (size_t)e * d * F + (size_t)c * F;
      if (ACT == kSwiglu) {
        const V* Wg = wg + (size_t)e * d * F + (size_t)c * F;
        for (int k = 0; k < F; ++k)
          acc = fmaf(to_f(dg[row * F + k]), to_f(Wg[k]), acc);
      }
      for (int k = 0; k < F; ++k)
        acc = fmaf(to_f(du[row * F + k]), to_f(Wu[k]), acc);
    }
    dx[row * d + c] = from_f<V>(acc);
  }
}

// out_b[e][m][n] = sum over weight row e's live rows of a[row][m] b_b[row][n];
// one column n a thread, kFRows values of m.
template <typename V, int NB>
__global__ void __launch_bounds__(kFThreads)
moe_bwd_weight_fma(const V* __restrict__ a, const V* __restrict__ b0,
                   const V* __restrict__ b1, const int32_t* __restrict__ index,
                   V* __restrict__ out0, V* __restrict__ out1, int S, int T,
                   int E, int M, int N) {
  const Index ix(index, S, T, E);
  const int e = blockIdx.z, m0 = blockIdx.y * kFRows;
  const int n = blockIdx.x * kFThreads + threadIdx.x;
  if (n >= N) return;
  const int32_t* rows = ix.packed + ix.seg_off[e];
  const int n_rows = ix.seg_n[e];
  float c0[kFRows], c1[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) c0[i] = c1[i] = 0.f;
  for (int j = 0; j < n_rows; ++j) {
    const size_t row = rows[j];
    const float v0 = to_f(b0[row * N + n]);
    const float v1 = NB == 2 ? to_f(b1[row * N + n]) : 0.f;
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      if (m0 + i < M) {
        const float av = to_f(a[row * M + m0 + i]);
        c0[i] = fmaf(av, v0, c0[i]);
        if (NB == 2) c1[i] = fmaf(av, v1, c1[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    if (m0 + i < M) {
      const size_t o = (size_t)e * M * N + (size_t)(m0 + i) * N + n;
      out0[o] = from_f<V>(c0[i]);
      if (NB == 2) out1[o] = from_f<V>(c1[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

int num_sms() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

// One call's tensors and shapes. Without a gate, wg, dg and dwg alias wu,
// du and dwu (the kernels then read and write only the latter).
struct Args {
  const void *x, *wg, *wu, *wd, *dy;
  const int32_t *se, *counts, *index;
  void *h, *dg, *du, *xp, *dyp, *dh, *dx, *dwg, *dwu, *dwd;
  int S, T, d, F, E, B;
  cudaStream_t st;
};

template <typename V>
const V* in(const void* p) { return static_cast<const V*>(p); }
template <typename V>
V* out(void* p) { return static_cast<V*>(p); }

template <int ACT>
cudaError_t run_wgmma(const Args& a) {
  constexpr bool kGate = ACT == kSwiglu;
  constexpr int kGU = kGate ? 2 : 1, kGUN = kGate ? 128 : 256;
  using HR = typename Hidden<ACT>::Rg;
  using GR = WeightRing<kGU, kGUN>;
  using DR = WeightRing<1, 256>;
  const int S = a.S, T = a.T, d = a.d, F = a.F, E = a.E;
  const int P = pack_rows(S, T, E);
  // packed scratch: encoded each call; weights: cached by pointer and box
  CUtensorMap x128, dy128, dg128, du128, x64, dy64, h64, dg64, du64;
  CUtensorMap wg_n, wu_n, wd_k, wg_k, wu_k;
  if (!encode(&x128, a.xp, d, P, 1, kTM) ||
      !encode(&dy128, a.dyp, d, P, 1, kTM) ||
      !encode(&du128, a.du, F, P, 1, kTM) || !encode(&x64, a.xp, d, P, 1, 64) ||
      !encode(&dy64, a.dyp, d, P, 1, 64) || !encode(&h64, a.h, F, P, 1, 64) ||
      !encode(&du64, a.du, F, P, 1, 64) ||
      !weight_map(&wu_n, a.wu, F, d, E, 64) ||
      !weight_map(&wd_k, a.wd, d, F, E, kRN) ||
      !weight_map(&wu_k, a.wu, F, d, E, kRN))
    return cudaErrorInvalidValue;
  if (kGate && (!encode(&dg128, a.dg, F, P, 1, kTM) ||
                !encode(&dg64, a.dg, F, P, 1, 64) ||
                !weight_map(&wg_n, a.wg, F, d, E, 64) ||
                !weight_map(&wg_k, a.wg, F, d, E, kRN)))
    return cudaErrorInvalidValue;
  if (!kGate) {
    dg128 = du128;
    dg64 = du64;
    wg_n = wu_n;
    wg_k = wu_k;
  }
  static bool attr[5] = {false, false, false, false, false};
  cudaError_t err;
  if ((err = set_smem(moe_bwd_dh, RowsRing::kSmem, attr[0])) ||
      (err = set_smem(moe_bwd_hidden<ACT>, HR::kSmem, attr[1])) ||
      (err = set_smem(moe_bwd_input<ACT>, RowsRing::kSmem, attr[2])) ||
      (err = set_smem(moe_bwd_weight_gu<kGU, kGUN>, GR::kSmem, attr[3])) ||
      (err = set_smem(moe_bwd_weight_down, DR::kSmem, attr[4])))
    return err;
  const int pack_rows_max = P > S * T ? P : S * T;
  moe_bwd_pack<<<dim3(cdiv(pack_rows_max, kPackThreads / 32), 2),
                 kPackThreads, 0, a.st>>>(
      in<bf16>(a.x), in<bf16>(a.dy), a.se, a.counts, a.index, out<bf16>(a.xp),
      out<bf16>(a.dyp), out<bf16>(a.dx), S, T, d, E, a.B);
  if ((err = cudaGetLastError())) return err;
  const unsigned tiles = (unsigned)max_tiles(P);
  moe_bwd_dh<<<dim3(tiles, cdiv(F, kRN)), kWThreads, RowsRing::kSmem, a.st>>>(
      dy128, wd_k, a.index, out<float>(a.dh), S, T, d, F, E);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_hidden<ACT><<<dim3(tiles, cdiv(F, kHN)), kWThreads, HR::kSmem,
                        a.st>>>(x128, wg_n, wu_n, a.index, in<float>(a.dh),
                                out<bf16>(a.h), out<bf16>(a.dg),
                                out<bf16>(a.du), S, T, d, F, E);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_input<ACT><<<dim3(tiles, cdiv(d, kRN)), kWThreads, RowsRing::kSmem,
                       a.st>>>(dg128, du128, wg_k, wu_k, a.index,
                               out<bf16>(a.dx), S, T, d, F, E);
  if ((err = cudaGetLastError())) return err;
  const long long gu_tiles = (long long)E * cdiv(d, kWM) * cdiv(F, kGUN);
  const long long down_tiles = (long long)E * cdiv(F, kWM) * cdiv(d, 256);
  if (gu_tiles > INT_MAX || down_tiles > INT_MAX) return cudaErrorInvalidValue;
  const int sms = num_sms();
  moe_bwd_weight_gu<kGU, kGUN>
      <<<(unsigned)(gu_tiles < sms ? gu_tiles : sms), kWThreads, GR::kSmem,
         a.st>>>(x64, kGate ? dg64 : du64, du64, a.index, out<bf16>(a.dwg),
                 out<bf16>(a.dwu), S, T, E, d, F);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_weight_down<<<(unsigned)(down_tiles < sms ? down_tiles : sms),
                        kWThreads, DR::kSmem, a.st>>>(
      h64, dy64, a.index, out<bf16>(a.dwd), S, T, E, d, F);
  return cudaGetLastError();
}

template <typename V, int ACT>
cudaError_t run_fma(const Args& a) {
  constexpr int kGU = ACT == kSwiglu ? 2 : 1;
  const int S = a.S, T = a.T, d = a.d, F = a.F, E = a.E;
  cudaError_t err;
  moe_bwd_hidden_fma<V, ACT>
      <<<dim3(cdiv(T, kFRows), cdiv(F, kFThreads), S), kFThreads, 0, a.st>>>(
          in<V>(a.x), in<V>(a.dy), in<V>(a.wg), in<V>(a.wu), in<V>(a.wd),
          a.se, a.index, out<V>(a.h), out<V>(a.dg), out<V>(a.du), S, T, d, F,
          E);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_input_fma<V, ACT>
      <<<dim3(cdiv(T, kFRows), cdiv(d, kFThreads), S), kFThreads, 0, a.st>>>(
          out<V>(a.dg), out<V>(a.du), in<V>(a.wg), in<V>(a.wu), a.se,
          a.counts, out<V>(a.dx), T, d, F, E, a.B);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_weight_fma<V, kGU>
      <<<dim3(cdiv(F, kFThreads), cdiv(d, kFRows), E), kFThreads, 0, a.st>>>(
          in<V>(a.x), out<V>(a.dg), out<V>(a.du), a.index, out<V>(a.dwg),
          out<V>(a.dwu), S, T, E, d, F);
  if ((err = cudaGetLastError())) return err;
  moe_bwd_weight_fma<V, 1>
      <<<dim3(cdiv(d, kFThreads), cdiv(F, kFRows), E), kFThreads, 0, a.st>>>(
          out<V>(a.h), in<V>(a.dy), in<V>(a.dy), a.index, out<V>(a.dwd),
          out<V>(a.dwd), S, T, E, F, d);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t run(const Args& a, int dtype, int aligned) {
  if (dtype == 0) return run_fma<float, ACT>(a);
  if (aligned) return run_wgmma<ACT>(a);
  return run_fma<bf16, ACT>(a);
}

bool bad_shape(int S, int T, int E, int B) {
  return S <= 0 || T <= 0 || E <= 0 || S > 65535 || E > 65535 || B <= 0 ||
         T % B != 0 || (long long)S * T + (long long)E * kTile >= INT_MAX;
}

}  // namespace

// x, dy: (S, T, d); w_gate, w_up: (E, d, F) (w_gate read for swiglu only);
// w_down: (E, F, d); all of one dtype (0 = float32, 1 = bfloat16);
// slot_experts: (S,) int32; row_counts: (S, B) int32, T % B == 0, or null
// (every row live). Scratch, with P = S T + E (64 - 1) packed rows: h, dg,
// du (P, F) of x's dtype (dg unused unless swiglu); packed: the packed x
// and dy (2, P, d) in bf16, then dh (P, F) in fp32, 4 P (d + F) bytes
// (null on the FMA path); index: int32 of 2 S + 2 E + 2 + 3 ceil(P / 64) +
// P (moe_gemm.py::bwd_index_size). dx: (S, T, d); dw_gate (swiglu only),
// dw_up: (E, d, F); dw_down: (E, F, d). activation: 0 = swiglu, 1 = gelu,
// 2 = relu. aligned = 1 when d and F are multiples of 8 and every pointer
// is 16-byte aligned (bf16 then takes the TMA + wgmma kernels, seven
// launches; otherwise the FMA kernels, five).
// Returns the first launch error (0 = all launched).
extern "C" int moe_gemm_bwd(const void* x, const void* w_gate,
                            const void* w_up, const void* w_down,
                            const void* slot_experts, const void* row_counts,
                            const void* dy, void* h, void* dg, void* du,
                            void* packed, void* index, void* dx,
                            void* dw_gate, void* dw_up, void* dw_down, int S,
                            int T, int d, int F, int E, int B, int activation,
                            int dtype, int aligned, void* stream) {
  if (bad_shape(S, T, E, B) || d <= 0 || F <= 0 || activation < 0 ||
      activation > 2 || cdiv(F, kFThreads) > 65535 ||
      cdiv(d, kFThreads) > 65535 || cdiv(d, kFRows) > 65535 ||
      cdiv(F, kFRows) > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const bool gate = activation == kSwiglu;
  const size_t P = (size_t)pack_rows(S, T, E);
  bf16* xp = static_cast<bf16*>(packed);
  bf16* dyp = xp == nullptr ? nullptr : xp + P * d;
  float* dhp = xp == nullptr ? nullptr
                             : reinterpret_cast<float*>(xp + 2 * P * d);
  const Args a{x, gate ? w_gate : w_up, w_up, w_down, dy,
               static_cast<const int32_t*>(slot_experts),
               static_cast<const int32_t*>(row_counts),
               static_cast<const int32_t*>(index), h, gate ? dg : du, du,
               xp, dyp, dhp, dx, gate ? dw_gate : dw_up, dw_up, dw_down,
               S, T, d, F, E, B, static_cast<cudaStream_t>(stream)};
  moe_bwd_rows<<<1, kPrepThreads, 0, a.st>>>(
      a.se, a.counts, static_cast<int32_t*>(index), S, T, E, B);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return activation == kSwiglu ? run<kSwiglu>(a, dtype, aligned)
         : activation == kGelu ? run<kGelu>(a, dtype, aligned)
                               : run<kRelu>(a, dtype, aligned);
}

// The packed layout alone: moe_bwd_rows into index (sized as above), for
// the tests that hold it against its plain mirror.
extern "C" int moe_gemm_bwd_index(const void* slot_experts,
                                  const void* row_counts, void* index, int S,
                                  int T, int E, int B, void* stream) {
  if (bad_shape(S, T, E, B)) return cudaErrorInvalidValue;
  moe_bwd_rows<<<1, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slot_experts),
      static_cast<const int32_t*>(row_counts), static_cast<int32_t*>(index),
      S, T, E, B);
  return cudaGetLastError();
}
