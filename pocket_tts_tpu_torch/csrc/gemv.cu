// Skinny matmul y [R, O] = x [R, I] @ W [O, I].T for R <= 32 rows, with
// plain (f32 / bf16) or weight-only int8 rows and per-output-row f32 scales.
//
// Replaces the Pallas kernel pocket_tts_tpu/ops/gemv.py (gemv_t:
// _kernel_plain, _kernel_quant). Rounding follows the port's plain version
// (ops/gemv.py gemv_plain), which follows the JAX package's XLA path: f32
// sums; plain weights give the sum rounded to promote(x, W); int8 weights are
// widened to x's dtype, the sum is rounded to x's dtype, multiplied by the
// row's f32 scale and rounded again (the TPU kernel instead scales the f32
// sum, one rounding fewer).
//
// Bound on the H100: bytes. At R <= 32 every weight is used by at most 32
// rows of x, far below the ~295 operations per byte where the tensor cores
// would bind; the least time is the bytes of W (plus x and y) at 3.35 TB/s:
// w1 4096x1024 bf16 at 32 rows moves 8.4 MB, 2.5 us (int8 half the weights).
//
// bf16 and int8 weights (every serving product) run on the tensor cores,
// swap-AB: y^T = W . x^T with W as operand A of mma.sync.m16n8k16 (16
// output rows x 16 k) and x^T as operand B (8 rows of x per n-tile, up to 4
// n-tiles at 32 rows), f32 sums in registers. The first design multiplied
// each 16-byte weight load by all R rows of x on CUDA cores, with x staged
// as f32 in shared memory and re-read by every lane for every owned weight
// row: at 32 rows 8 float4 shared-memory reads per 16 weight bytes bound it.
// Here one x value feeds 16 weight rows in one mma. The sum over k may take
// k in any order as long as A and B agree, so each lane's A fragment is 16
// contiguous bytes of its two weight rows (g and g + 8 of the tile; 8 bf16
// or 16 int8 values) and its B fragment the same k of x row g of each
// n-tile: no ldmatrix, no shuffle. int8 values widen to bf16 exactly in
// registers, so the int8 product is the plain version's bf16 x by
// int8->bf16 W with an f32 sum. Each lane streams its own weight and x words
// through its warp's ring in shared memory (cp.async, 2 to 8 stages, about
// 12 KB per warp), so the ring needs no barrier. K is split over 16 warps of
// a 512-thread block below 132 tiles (out_proj and w2: 64) and over 4 from
// 132 up; the partial sums meet in shared memory, where the epilogue adds
// them in a fixed order and applies the rounding points. mma.sync and not
// wgmma: wgmma wants 64-row M tiles and its B operand in shared memory, and
// at these sizes the weight stream, not the tensor cores, sets the time.
//
// Measured (chip_smoke.py, graph-replayed device time, weights cold in L2;
// H100 80GB HBM3 at 700 W): w1 at 32 rows 0.0066-0.0075 ms (35-39% of the
// bound) against torch.matmul's 0.0057-0.0060; at 1 row 0.0052-0.0058
// against 0.0057-0.0059. nvcc -Xptxas -v (sm_90a, on the card): 34
// instantiations of 33-167 registers, no spill; the CUDA-core body's 18 keep
// their earlier counts (40-167), the 16 tensor-core ones take the rest
// (33-96). Dynamic shared memory: 10-18 KB of ring per warp (48 KB for a
// 4-warp block, 192 KB for 16), reused for the sums.
//
// At 32 rows the x words' copies, the mma and the split-K epilogue add to the
// weight stream instead of hiding under it (bring-up variants without each
// were each faster): with K = 1024 each warp holds only 8 slabs. Staging x
// once per block, sharing x over 2 or 4 tiles per warp, and a cluster
// split-K each measured slower than this layout, as did int8 slabs of 8
// values a lane (8-byte copies through L1), which carry only bf16's x words
// per weight value: int8 at 32 rows stays level with bf16.
//
// f32 activations over bf16 or int8 weights (the flow head, int8-f32): the
// weights are exact in bf16, and x is split into three bf16 terms (hi, mid,
// lo: 24 bits of mantissa) issued as three mmas into the same f32 sum; the
// card reads at most 1.3e-6 of max |plain| against the f32 bar of 1e-4.
//
// CUDA cores keep the first design's body for f32 x f32 (the f32 model
// only; TF32 would break the f32 bar) and for f32 x at one row (the flow
// head at batch 1: products of at most 1.5 MB, where its smaller fixed cost
// wins, 2.7 against 2.9 us per launch).

#include <algorithm>

#include "common.cuh"

namespace {

using namespace pt;

// ------------------------------------------------------------ tensor cores

constexpr int kMmaMaxThreads = 512;
constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory a block may take

// A lane's 16 weight bytes as bf16 pairs: 4 pairs (bf16) or 8 (int8, widened
// exactly: the byte's value + 2^23 + 128 is exact in f32).
template <typename WT> struct WFrag;
template <> struct WFrag<__nv_bfloat16> {
  static constexpr int pairs = 4;
  __device__ __forceinline__ static void widen(const uint4& u, uint32_t* o) {
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  }
};
template <> struct WFrag<int8_t> {
  static constexpr int pairs = 8;
  __device__ __forceinline__ static void widen(const uint4& u, uint32_t* o) {
    const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                           u.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)  // bytes b, 0, 0, 0x4B: 2^23 + (v + 128)
        f[b] = __int_as_float(__byte_perm(w[i], 0x4B00u, 0x5440u | b)) - 8388736.f;
      o[2 * i] = pack_bf16(f[0], f[1]);
      o[2 * i + 1] = pack_bf16(f[2], f[3]);
    }
  }
};

// A lane's x values for one slab of one x row: 2 * PAIRS values in the same
// k order as its weight bytes, loaded raw (U 16-byte words), then taken
// apart into `terms` bf16 terms of PAIRS pairs each.
template <typename XT, int PAIRS> struct XFrag;
template <int PAIRS> struct XFrag<__nv_bfloat16, PAIRS> {
  static constexpr int terms = 1, U = PAIRS / 4;
  __device__ __forceinline__ static void split(const uint4* u, uint32_t (*o)[PAIRS]) {
#pragma unroll
    for (int v = 0; v < U; ++v) {
      o[0][4 * v] = u[v].x; o[0][4 * v + 1] = u[v].y;
      o[0][4 * v + 2] = u[v].z; o[0][4 * v + 3] = u[v].w;
    }
  }
};
template <int PAIRS> struct XFrag<float, PAIRS> {
  static constexpr int terms = 3, U = PAIRS / 2;
  __device__ __forceinline__ static void split(const uint4* u, uint32_t (*o)[PAIRS]) {
#pragma unroll
    for (int v = 0; v < U; ++v) {
      const float f[4] = {__uint_as_float(u[v].x), __uint_as_float(u[v].y),
                          __uint_as_float(u[v].z), __uint_as_float(u[v].w)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = f[2 * h], b = f[2 * h + 1];
#pragma unroll
        for (int term = 0; term < 3; ++term) {  // hi, mid, lo: each the rest's bf16
          const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
          o[term][2 * v + h] = *reinterpret_cast<const uint32_t*>(&r);
          a -= __low2float(r);  // exact: the rounding's residual
          b -= __high2float(r);
        }
      }
    }
  }
};

// The copy ring: each warp streams its k slabs through a few stages of
// shared memory, filled with cp.async. A stage holds the lane's 16 weight
// bytes of its two rows and its x words (U 16-byte words for each of NT
// n-tiles), each a 512-byte row of 32 lanes' words.
constexpr int kRowBytes = 16 * 32;
constexpr int kRingBytes = 13 * 1024;  // per warp: 16 warps fit in 227 KB

template <typename XT, typename WT, int NT>
struct Ring {
  static constexpr int U = XFrag<XT, WFrag<WT>::pairs>::U;
  static constexpr int rows = 2 + NT * U;  // 512-byte rows per stage
  static constexpr int stage = rows * kRowBytes;
  static constexpr int stages = kRingBytes / stage < 2 ? 2
                                : kRingBytes / stage > 8 ? 8 : kRingBytes / stage;
  static constexpr int bytes = stages * stage;  // per warp
};

// One block per tile of 16 output rows, its wk warps splitting K: warp w owns
// the k slabs w, w + wk, w + 2 wk, ... A slab is 16 weight bytes per lane per
// row, 4 lanes (t = lane % 4) side by side: 32 (bf16) or 64 (int8) k, of
// which lane t holds [t, t + 1) * LW, where LW = 16 / sizeof(WT); mma step j
// of the slab takes the lane's pairs 2j and 2j + 1 as the (2t, 2t + 1) and
// (2t + 8, 2t + 9) columns of A, and the same pairs of x as those rows of B. Each lane copies its own weight and x words into its
// warp's ring, stages - 1 slabs ahead, and reads them back itself, so the
// ring needs no barrier. x goes through L1 (`x_l1`) where several blocks
// share an SM and read the same x, else around it, as the weights do.
template <typename XT, typename WT, typename OT, int NT, bool QUANT>
__global__ void __launch_bounds__(kMmaMaxThreads)
gemv_mma_kernel(const XT* __restrict__ x, const WT* __restrict__ W,
                const float* __restrict__ s, OT* __restrict__ y, int R, int O, int I, int wk,
                bool x_l1) {
  using RG = Ring<XT, WT, NT>;
  constexpr int PAIRS = WFrag<WT>::pairs;
  constexpr int LW = 2 * PAIRS;  // k per lane per slab
  constexpr int SK = 4 * LW;     // k per slab
  constexpr int XS = XFrag<XT, PAIRS>::terms, U = RG::U, S = RG::stages;
  constexpr int COLS = NT * 8, XV = 16 / sizeof(XT);
  extern __shared__ __align__(16) unsigned char smem[];  // the rings, then the sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * 16;
  const int nslab = (I + SK - 1) / SK;
  const int mine = nslab > warp ? (nslab - warp + wk - 1) / wk : 0;  // this warp's slabs
  const WT* wrow[2] = {W + static_cast<size_t>(min(row0 + g, O - 1)) * I,
                       W + static_cast<size_t>(min(row0 + g + 8, O - 1)) * I};
  const bool rok[2] = {row0 + g < O, row0 + g + 8 < O};
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + warp * RG::bytes + lane * 16;
  const uint4* ring_p = reinterpret_cast<const uint4*>(smem + warp * RG::bytes) + lane;

  auto issue = [&](int i) {  // slab i of this warp into stage i % S
    if (i < mine) {
      const int col = (warp + i * wk) * SK + t * LW;
      const int cc = min(col, I - LW);  // a valid address when nothing is copied
      const uint32_t st = ring + (i % S) * RG::stage;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cp_async16<false>(st + h * kRowBytes, wrow[h] + cc, col < I && rok[h]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = n * 8 + g;
#pragma unroll
        for (int v = 0; v < U; ++v) {
          const uint32_t dst = st + (2 + n * U + v) * kRowBytes;
          const XT* src = x + static_cast<size_t>(min(r, R - 1)) * I + cc + v * XV;
          if (x_l1)
            cp_async16<true>(dst, src, col < I && r < R);
          else
            cp_async16<false>(dst, src, col < I && r < R);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int i = 0; i < mine; ++i) {
    issue(i + S - 1);
    cp_async_wait<S - 1>();  // slab i has landed
    const uint4* st = ring_p + (i % S) * (RG::stage / 16);
    uint32_t a[2][PAIRS];
#pragma unroll
    for (int h = 0; h < 2; ++h) WFrag<WT>::widen(st[h * 32], a[h]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint4 xw[U];
#pragma unroll
      for (int v = 0; v < U; ++v) xw[v] = st[(2 + n * U + v) * 32];
      uint32_t b[XS][PAIRS];
      XFrag<XT, PAIRS>::split(xw, b);
#pragma unroll
      for (int j = 0; j < PAIRS / 2; ++j)
#pragma unroll
        for (int term = 0; term < XS; ++term)
          mma_bf16(acc[n], a[0][2 * j], a[1][2 * j], a[0][2 * j + 1], a[1][2 * j + 1],
                   b[term][2 * j], b[term][2 * j + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the sums reuse its space

  // C fragment: (row g, cols 2t, 2t + 1) and (row g + 8, the same cols)
  float* red = reinterpret_cast<float*>(smem);  // [warps][16][COLS + 1]
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(warp * 16 + g + 8 * (c / 2)) * (COLS + 1) + n * 8 + 2 * t + c % 2] = acc[n][c];
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * R; e += blockDim.x) {
    const int r = e / 16, ol = e % 16;
    const int o = row0 + ol;
    if (o >= O) continue;
    float sum = 0.f;
    for (int k = 0; k < wk; ++k) sum += red[(k * 16 + ol) * (COLS + 1) + r];
    if (QUANT) {  // XLA's rounding points: the sum in x's dtype, then the scale
      y[static_cast<size_t>(r) * O + o] = from_f<OT>(round_t<XT>(sum) * s[o]);
    } else {
      y[static_cast<size_t>(r) * O + o] = from_f<OT>(sum);
    }
  }
}

// Warps splitting K in a tile's block. Below 132 tiles (64 at out_proj and
// w2) 16: one 512-thread block per tile and SM; from 132 up (in_proj, w1) 4,
// so that each warp keeps 8 slabs and the 128-thread blocks share the SMs.
// Every warp keeps at least one slab, and the rings fit in shared memory.
int split_k(int O, int I, int sk, int ring_bytes) {
  const int tiles = (O + 15) / 16, nslab = (I + sk - 1) / sk;
  int wk = tiles < 132 ? 16 : 4;
  while (wk > 1 && (wk > nslab || wk * ring_bytes > kSmemMax)) wk /= 2;
  return wk;
}

template <typename XT, typename WT, typename OT, int NT, bool QUANT>
cudaError_t launch_mma(const void* x, const void* W, const float* s, void* y, int R, int O,
                       int I, cudaStream_t st) {
  using RG = Ring<XT, WT, NT>;
  const int wk = split_k(O, I, 64 / static_cast<int>(sizeof(WT)), RG::bytes);
  const size_t sums = sizeof(float) * wk * 16 * (NT * 8 + 1);
  const size_t bytes = std::max(static_cast<size_t>(wk) * RG::bytes, sums);
  // raised once, to the most any block takes, before any stream capture
  static const cudaError_t allowed = allow_smem(gemv_mma_kernel<XT, WT, OT, NT, QUANT>, kSmemMax);
  if (allowed != cudaSuccess) return allowed;
  // x through L1 unless a bf16 x row meets a bf16 weight row in a block of
  // its own on the SM (measured: L1 pays where blocks share an SM and for
  // the int8 and f32 pairs' wider x words, and costs at 16 warps)
  const bool x_l1 = RG::U > 1 || wk < 16;
  gemv_mma_kernel<XT, WT, OT, NT, QUANT><<<(O + 15) / 16, 32 * wk, bytes, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(W), s, static_cast<OT*>(y), R, O, I, wk,
      x_l1);
  return cudaGetLastError();
}

template <typename XT, typename WT, typename OT, bool QUANT>
cudaError_t mma_by_rows(const void* x, const void* W, const float* s, void* y, int R, int O,
                        int I, cudaStream_t st) {
  if (R <= 8) return launch_mma<XT, WT, OT, 1, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 16) return launch_mma<XT, WT, OT, 2, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 24) return launch_mma<XT, WT, OT, 3, QUANT>(x, W, s, y, R, O, I, st);
  return launch_mma<XT, WT, OT, 4, QUANT>(x, W, s, y, R, O, I, st);
}

// ------------------------------------------------------------ CUDA cores

constexpr int kGemvThreads = 128;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kDepth = 4;  // tiles of weight loads in flight per lane

// A warp owns RPW output rows (two from 16 rows of x up); each lane reads 16
// bytes of each per tile (8 bf16, 4 f32 or 16 int8 values), kDepth tiles of
// loads issued before any is used, and keeps NR f32 partial sums per owned
// row. x is staged per tile as f32 in shared memory ([NR][32 x values per
// lane]). QUANT: W is int8 and `s` holds one f32 scale per output row.
template <typename XT, typename WT, typename OT, int NR, int RPW, bool QUANT>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const XT* __restrict__ x, const WT* __restrict__ W, const float* __restrict__ s,
            OT* __restrict__ y, int R, int O, int I) {
  constexpr int V = Vec16<WT>::n;
  constexpr int KT = 32 * V;  // columns per tile: one 16-byte load per lane
  extern __shared__ __align__(16) float xs[];  // [NR][KT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = (blockIdx.x * kGemvWarps + warp) * RPW;
  const int tiles = (I + KT - 1) / KT;
  float acc[RPW][NR];
#pragma unroll
  for (int p = 0; p < RPW; ++p)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[p][r] = 0.f;

  for (int t0 = 0; t0 < tiles; t0 += kDepth) {
    uint4 buf[kDepth][RPW];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int col = (t0 + d) * KT + lane * V;
#pragma unroll
      for (int p = 0; p < RPW; ++p)
        buf[d][p] = (col < I && row0 + p < O)
                        ? load16(W + static_cast<size_t>(row0 + p) * I + col)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int t = t0 + d;
      if (t >= tiles) break;  // uniform across the block
      __syncthreads();        // the previous tile's reads of xs are done
      for (int i = tid; i < NR * KT; i += kGemvThreads) {
        const int r = i / KT, col = t * KT + i % KT;
        xs[i] = (r < R && col < I) ? to_f<XT>(x[static_cast<size_t>(r) * I + col]) : 0.f;
      }
      __syncthreads();
      const int col = t * KT + lane * V;
      if (col >= I) continue;
#pragma unroll
      for (int p = 0; p < RPW; ++p) {
        if (row0 + p >= O) continue;
        float w[V];
        Vec16<WT>::unpack(buf[d][p], w);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float* xr = xs + r * KT + lane * V;
          float a = acc[p][r];
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + j);
            a = fmaf(w[j], xv.x, fmaf(w[j + 1], xv.y, fmaf(w[j + 2], xv.z, fmaf(w[j + 3], xv.w, a))));
          }
          acc[p][r] = a;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < RPW; ++p) {
    const int o = row0 + p;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float a = warp_sum(acc[p][r]);
      if (lane == r && r < R && o < O) {
        if (QUANT) {
          // XLA's rounding points: the sum in x's dtype, then the scale
          const float yv = round_t<XT>(a);
          y[static_cast<size_t>(r) * O + o] = from_f<OT>(yv * s[o]);
        } else {
          y[static_cast<size_t>(r) * O + o] = from_f<OT>(a);
        }
      }
    }
  }
}

template <typename XT, typename WT, typename OT, int NR, bool QUANT>
cudaError_t launch_cc(const void* x, const void* W, const float* s, void* y, int R, int O, int I,
                   cudaStream_t st) {
  constexpr int RPW = NR >= 16 ? 2 : 1;
  constexpr int V = Vec16<WT>::n;
  const size_t bytes = static_cast<size_t>(NR) * 32 * V * sizeof(float);
  cudaError_t e = allow_smem(gemv_kernel<XT, WT, OT, NR, RPW, QUANT>, bytes);
  if (e != cudaSuccess) return e;
  const int rows_per_block = kGemvWarps * RPW;
  gemv_kernel<XT, WT, OT, NR, RPW, QUANT>
      <<<(O + rows_per_block - 1) / rows_per_block, kGemvThreads, bytes, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(W), s, static_cast<OT*>(y), R, O, I);
  return cudaGetLastError();
}

template <typename XT, typename WT, typename OT, bool QUANT>
cudaError_t cc_by_rows(const void* x, const void* W, const float* s, void* y, int R, int O,
                       int I, cudaStream_t st) {
  if (R <= 1) return launch_cc<XT, WT, OT, 1, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 2) return launch_cc<XT, WT, OT, 2, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 4) return launch_cc<XT, WT, OT, 4, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 8) return launch_cc<XT, WT, OT, 8, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 16) return launch_cc<XT, WT, OT, 16, QUANT>(x, W, s, y, R, O, I, st);
  return launch_cc<XT, WT, OT, 32, QUANT>(x, W, s, y, R, O, I, st);
}

}  // namespace

// xdt: 0 = float32, 1 = bfloat16. wdt: 0 = float32, 1 = bfloat16, 2 = int8
// (then `s` holds O f32 scales and y takes x's dtype; otherwise y takes
// promote(x, W)). x [R, I], W [O, I], y [R, O], all contiguous on the device,
// x and W 16-byte aligned with I a multiple of 16 bytes' worth of W values;
// 1 <= R <= 32. Returns cudaGetLastError(); 1 (cudaErrorInvalidValue) for a
// case it does not take.
extern "C" int gemv_run(int xdt, int wdt, int R, int O, int I, const void* x, const void* W,
                        const void* s, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  using bf = __nv_bfloat16;
  if (R < 1 || R > 32) return cudaErrorInvalidValue;
  // f32 x f32 on CUDA cores; f32 x at 1 row (the flow head at batch 1, up
  // to 1.5 MB of weights) too, where the CUDA-core body's smaller fixed cost
  // wins (2.7 against 2.9 us per launch on the H100)
  if (xdt == 0 && wdt == 0) return cc_by_rows<float, float, float, false>(x, W, sc, y, R, O, I, st);
  if (xdt == 0 && wdt == 1)
    return R == 1 ? cc_by_rows<float, bf, float, false>(x, W, sc, y, R, O, I, st)
                  : mma_by_rows<float, bf, float, false>(x, W, sc, y, R, O, I, st);
  if (xdt == 1 && wdt == 1) return mma_by_rows<bf, bf, bf, false>(x, W, sc, y, R, O, I, st);
  if (xdt == 0 && wdt == 2)
    return R == 1 ? cc_by_rows<float, int8_t, float, true>(x, W, sc, y, R, O, I, st)
                  : mma_by_rows<float, int8_t, float, true>(x, W, sc, y, R, O, I, st);
  if (xdt == 1 && wdt == 2) return mma_by_rows<bf, int8_t, bf, true>(x, W, sc, y, R, O, I, st);
  return cudaErrorInvalidValue;
}
