// Stacked int8 GEMV: y [L, R, O] = (x [R, I] @ Wq[l].T in f32) * s[l] for
// every layer l, with x bf16, Wq [L, O, I] int8 and s [L, O] f32 row scales.
//
// Replaces the Pallas kernel tools/int8_gemv_probe.py (`gemv_stack`, body
// `kernel`), the int8 GEMV probe's stacked weight stream. Numerics are the
// Pallas body's: bf16 x and int8 Wq widened to f32, exact f32 products (8
// significant bits times at most 8 bits fit in f32's 24), an f32 sum over I,
// the f32 sum times the f32 scale, stored as f32: one rounding of the sum, no
// rounding to the activation dtype before the scale (unlike gemv.cu, which
// follows the XLA path).
//
// Bound on the H100: bytes. Every int8 weight is used by R <= 32 rows of x per
// group, far below the ~295 operations per byte where the tensor cores would
// bind; the least time is Wq (plus s, x and y) at 3.35 TB/s (L=48, O=4096,
// I=1024: 201 MB of Wq, ~0.061 ms at R=1). The design streams each weight row
// once per group of 32 rows of x: a warp owns RPW output rows and each lane
// reads 16 int8 values of each (one 16-byte load) per 512-column tile, with
// kDepth tiles of loads issued before any is used; x is staged per tile in
// shared memory as f32 in a lane-major order (a lane's four float4 reads of a
// row are consecutive across the warp, so no bank conflicts); NR x RPW f32
// partial sums per lane. A block covers 8 warps x RPW output rows of one
// layer; the grid is (O blocks, L, groups of 32 rows of x), one launch per
// call. The scaled sums go through shared memory so that each row of y is
// written with consecutive stores. CUDA-core FMAs only: at 32 rows the
// shared-memory reads of x and the FMAs, not the weight stream, limit it.

#include "common.cuh"

namespace {

using namespace pt;

constexpr int kStackThreads = 256;
constexpr int kStackWarps = kStackThreads / 32;
constexpr int kTile = 32 * 16;  // columns per tile: one 16-byte int8 load per lane
constexpr int kDepth = 2;       // tiles of weight loads in flight per lane
constexpr int kMaxGroup = 32;   // rows of x per group (grid z)

// x column c of a tile lives at xs[r][((c % 16) / 4 * 32 + c / 16) * 4 + c % 4]:
// lane c / 16 reads its 16 values as four float4 at q * 128 + lane * 4.
__device__ __forceinline__ int swizzle(int c) {
  return (((c & 15) >> 2) * 32 + (c >> 4)) * 4 + (c & 3);
}

template <int NR, int RPW>
__global__ void __launch_bounds__(kStackThreads)
gemv_stack_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ Wq,
                  const float* __restrict__ s, float* __restrict__ y, int R, int O, int I) {
  extern __shared__ __align__(16) float xs[];  // [NR][kTile]; reused for the outputs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l = blockIdx.y;
  const int r0 = blockIdx.z * kMaxGroup;
  const int o0 = blockIdx.x * kStackWarps * RPW;
  const int row0 = o0 + warp * RPW;
  const int tiles = (I + kTile - 1) / kTile;
  const int8_t* Wl = Wq + static_cast<size_t>(l) * O * I;
  float acc[RPW][NR];
#pragma unroll
  for (int p = 0; p < RPW; ++p)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[p][r] = 0.f;

  for (int t0 = 0; t0 < tiles; t0 += kDepth) {
    uint4 buf[kDepth][RPW];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int col = (t0 + d) * kTile + lane * 16;
#pragma unroll
      for (int p = 0; p < RPW; ++p)
        buf[d][p] = (col < I && row0 + p < O)
                        ? load16(Wl + static_cast<size_t>(row0 + p) * I + col)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int t = t0 + d;
      if (t >= tiles) break;  // uniform across the block
      __syncthreads();        // the previous tile's reads of xs are done
      // 8 columns (one 16-byte load of x) per step; I % 16 == 0, so the 8
      // are all in or all out
      for (int i = tid; i < NR * (kTile / 8); i += kStackThreads) {
        const int r = i / (kTile / 8), c = i % (kTile / 8) * 8, col = t * kTile + c;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r0 + r < R && col < I)
          Vec16<__nv_bfloat16>::load(x + static_cast<size_t>(r0 + r) * I + col, v);
        float* row = xs + r * kTile;
        *reinterpret_cast<float4*>(row + swizzle(c)) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(row + swizzle(c + 4)) = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
      if (t * kTile + lane * 16 >= I) continue;  // I % 16 == 0: a lane's 16 are all in or out
#pragma unroll
      for (int p = 0; p < RPW; ++p) {
        float w[16];
        Vec16<int8_t>::unpack(buf[d][p], w);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float* xr = xs + r * kTile + lane * 4;
          float a = acc[p][r];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + q * 128);
            a = fmaf(w[4 * q], xv.x, a);
            a = fmaf(w[4 * q + 1], xv.y, a);
            a = fmaf(w[4 * q + 2], xv.z, a);
            a = fmaf(w[4 * q + 3], xv.w, a);
          }
          acc[p][r] = a;
        }
      }
    }
  }

  // the f32 sum times the f32 row scale, then [NR][rows of the block] in
  // shared memory, written out row by row of y
  constexpr int kBlockRows = kStackWarps * RPW;
  float* out = xs;
  __syncthreads();  // the last tile's reads of xs are done
#pragma unroll
  for (int p = 0; p < RPW; ++p) {
    const int o = row0 + p;
    const float sc = o < O ? s[static_cast<size_t>(l) * O + o] : 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float a = warp_sum(acc[p][r]);
      if (lane == r) out[r * kBlockRows + warp * RPW + p] = a * sc;
    }
  }
  __syncthreads();
  for (int i = tid; i < NR * kBlockRows; i += kStackThreads) {
    const int r = i / kBlockRows, c = i % kBlockRows;
    if (r0 + r < R && o0 + c < O)
      y[(static_cast<size_t>(l) * R + r0 + r) * O + o0 + c] = out[i];
  }
}

template <int NR>
cudaError_t launch(const void* x, const void* Wq, const float* s, float* y, int R, int L, int O,
                   int I, cudaStream_t st) {
  constexpr int RPW = NR >= 16 ? 2 : 4;
  const size_t bytes = static_cast<size_t>(NR) * kTile * sizeof(float);
  cudaError_t e = allow_smem(gemv_stack_kernel<NR, RPW>, bytes);
  if (e != cudaSuccess) return e;
  const int rows_per_block = kStackWarps * RPW;
  const dim3 grid((O + rows_per_block - 1) / rows_per_block, L,
                  (R + kMaxGroup - 1) / kMaxGroup);
  gemv_stack_kernel<NR, RPW><<<grid, kStackThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(Wq), s, y, R, O, I);
  return cudaGetLastError();
}

}  // namespace

// x [R, I] bf16, Wq [L, O, I] int8, s [L, O] f32, y [L, R, O] f32, all
// contiguous on the device, x and Wq 16-byte aligned; I a multiple of 16; any
// R >= 1 (groups of 32 rows of x in one launch); L <= 65535. Returns
// cudaGetLastError(); 1 (cudaErrorInvalidValue) for a case it does not take.
extern "C" int gemv_stack_run(int R, int L, int O, int I, const void* x, const void* Wq,
                              const void* s, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  float* out = static_cast<float*>(y);
  if (R < 1 || L < 1 || L > 65535 || O < 1 || I < 16 || I % 16 ||
      (R + kMaxGroup - 1) / kMaxGroup > 65535)
    return cudaErrorInvalidValue;
  if (R <= 1) return launch<1>(x, Wq, sc, out, R, L, O, I, st);
  if (R <= 2) return launch<2>(x, Wq, sc, out, R, L, O, I, st);
  if (R <= 4) return launch<4>(x, Wq, sc, out, R, L, O, I, st);
  if (R <= 8) return launch<8>(x, Wq, sc, out, R, L, O, I, st);
  if (R <= 16) return launch<16>(x, Wq, sc, out, R, L, O, I, st);
  return launch<32>(x, Wq, sc, out, R, L, O, I, st);
}
