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
// would bind; the least time is the bytes of W (plus x and y) at 3.35 TB/s
// (in_proj 3072x1024 bf16: 6.3 MB, 1.9 us; int8 half that). The design
// streams each W row exactly once: a warp owns one output row (two from 16
// rows of x up, halving the shared-memory reads per FMA), each lane reads
// 16 bytes of the row per tile (8 bf16, 4 f32 or 16 int8 values) with kDepth
// tiles of loads issued before any is used, and keeps NR f32 partial sums
// per owned row in registers. x is staged per tile, as f32, in shared memory
// ([NR][32 x values-per-lane], at most 64 KB), since all of x (256 KB at
// R = 32, I = 4096 in bf16) does not fit. CUDA-core FMAs only: at R = 32 the
// shared-memory reads, not the weight stream, limit this first design.

#include "common.cuh"

namespace {

using namespace pt;

constexpr int kGemvThreads = 128;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kDepth = 4;  // tiles of weight loads in flight per lane

// QUANT: W is int8 and `s` holds one f32 scale per output row.
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
cudaError_t launch(const void* x, const void* W, const float* s, void* y, int R, int O, int I,
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
cudaError_t by_rows(const void* x, const void* W, const float* s, void* y, int R, int O, int I,
                    cudaStream_t st) {
  if (R <= 1) return launch<XT, WT, OT, 1, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 2) return launch<XT, WT, OT, 2, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 4) return launch<XT, WT, OT, 4, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 8) return launch<XT, WT, OT, 8, QUANT>(x, W, s, y, R, O, I, st);
  if (R <= 16) return launch<XT, WT, OT, 16, QUANT>(x, W, s, y, R, O, I, st);
  return launch<XT, WT, OT, 32, QUANT>(x, W, s, y, R, O, I, st);
}

}  // namespace

// xdt: 0 = float32, 1 = bfloat16. wdt: 0 = float32, 1 = bfloat16, 2 = int8
// (then `s` holds O f32 scales and y takes x's dtype; otherwise y takes
// promote(x, W)). x [R, I], W [O, I], y [R, O], all contiguous on the device,
// W 16-byte aligned with I a multiple of 16 bytes' worth of values;
// 1 <= R <= 32. Returns cudaGetLastError(); 1 (cudaErrorInvalidValue) for a
// case it does not take.
extern "C" int gemv_run(int xdt, int wdt, int R, int O, int I, const void* x, const void* W,
                        const void* s, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  using bf = __nv_bfloat16;
  if (R < 1 || R > 32) return cudaErrorInvalidValue;
  if (xdt == 0 && wdt == 0) return by_rows<float, float, float, false>(x, W, sc, y, R, O, I, st);
  if (xdt == 0 && wdt == 1) return by_rows<float, bf, float, false>(x, W, sc, y, R, O, I, st);
  if (xdt == 1 && wdt == 1) return by_rows<bf, bf, bf, false>(x, W, sc, y, R, O, I, st);
  if (xdt == 0 && wdt == 2) return by_rows<float, int8_t, float, true>(x, W, sc, y, R, O, I, st);
  if (xdt == 1 && wdt == 2) return by_rows<bf, int8_t, bf, true>(x, W, sc, y, R, O, I, st);
  return cudaErrorInvalidValue;
}
