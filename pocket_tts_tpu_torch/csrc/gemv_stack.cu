// Stacked int8 GEMV: y [L, R, O] = (x [R, I] @ Wq[l].T in f32) * s[l] for
// every layer l, with x bf16, Wq [L, O, I] int8 and s [L, O] f32 row scales.
//
// Replaces the Pallas kernel tools/int8_gemv_probe.py (`gemv_stack`, body
// `kernel`), the int8 GEMV probe's stacked weight stream. Numerics are the
// Pallas body's: bf16 x times int8 Wq, exact products (8 significant bits
// times at most 8 fit in f32's 24), an f32 sum over I, the f32 sum times the
// f32 scale, stored as f32: one rounding of the sum, no rounding to the
// activation dtype before the scale (unlike gemv.cu, which follows the XLA
// path). Only the order of the sum differs from the plain version.
//
// Bound on the H100: bytes. Every int8 weight meets at most 48 rows of x
// per pass, far below the ~295 operations per byte where the tensor cores
// would bind: at the probe's L=48, O=4096, I=1024 the call moves 201 MB of
// Wq (203 MB in all at 1 row, 0.061 ms at 3.35 TB/s; 227 MB at 32 rows,
// 25 MB of them y, 0.068 ms) against 12.9 GFLOP at 32 rows (0.013 ms).
//
// Design: the whole call is one read of Wq as the flat [L*O, I] matrix.
// - One block per SM, persistent. Block b owns a contiguous span of 16-row
//   tiles (gemv_stack_plan.cuh: spans differ by at most one tile), walked in
//   rounds of seven adjacent warp tiles of 64 rows, tile j to consumer warp
//   j % 7; the last round splits what is left evenly (Span). A warp tile may
//   straddle two layers: each row finds its layer, scale and place in y
//   itself (l = row / O, o = row % O).
// - One producer warp streams the span by TMA: 2-D tensor copies of 16 rows
//   x 128 columns (one per 16-row tile of the warp tile) into a ring stage of
//   8 KB, one warp tile's 128-column chunk, completing on the stage's
//   mbarrier, marked evict-first in L2 (201 MB is read once; L2 holds 50 MB)
//   with 128-byte L2 requests (a box row; 256-byte promotion was 1-2% slower),
//   swizzled by 128 bytes. The ring (16-24 stages, what x leaves of the
//   227 KB) is filled in round order across tiles and layers; a warp waits
//   for its own stages only, so the warps run at their own pace.
// - Seven consumer warps on the tensor cores (with the producer, two warps
//   per SM sub-partition: 255 registers each), swap-AB as in gemv.cu: W is
//   operand A of mma.sync.m16n8k16 (16 weight rows x 16 k), x^T operand B
//   (8 rows of x per n-tile, up to 6 n-tiles), f32 sums in registers for
//   the warp's whole tile (one instantiation per tile height, so the tile
//   loop is straight code). A lane reads 16 contiguous weight bytes of each
//   of its two rows per 64-column slab and the same 16 k of x, so k runs in
//   any order A and B agree on. int8 widens to bf16 exactly in registers (a
//   byte permute builds 2^23 + (v + 128) in f32, one subtract, a byte
//   permute keeps the high halves of two; no conversion unit). Each x
//   fragment feeds the warp's 16-row tiles. The mma rows g and g + 8 read
//   box rows (g >> 1) | (g & 1) << 2 (and + 8), so the 128-byte swizzle
//   spreads every quarter-warp's 16-byte reads over all 32 banks.
// - x is staged once per block and pass by 1-D bulk copies (evict-last: all
//   132 blocks read it), row r at a stride of 2 * kc + 16 bytes, which keeps
//   the B fragments' reads free of bank conflicts too. Up to 48 rows of x go
//   in one pass (6 n-tiles, 96 KB at I = 1024: one pass was about 1.7x faster
//   than two 24-row groups at 48 rows); more rows take balanced groups,
//   each streaming Wq again; an I whose x rows do not fit takes column
//   passes, whose partial sums go through y (the same lane, in a fixed
//   order). The k past I is zero in the weights (TMA fills out of bounds)
//   and in x (registers), so a partial slab adds nothing.
// - Epilogue per warp tile, through its last ring stage: the sums go to
//   shared memory, then out as 16-byte streaming stores (st.global.cs) of
//   four consecutive o times their scales, each warp store two 256-byte
//   runs of y. No atomics, no split-K across warps or blocks: two launches
//   give the same bits, and a CUDA-graph replay the eager launch's.
//
// Measured (gemv_stack_turns.py, device time by graph replay, the weight
// cold in L2 by size; H100 80GB HBM3 at 700 W), against the parent kernel
// (a block per 32 rows x layer, CUDA-core FMAs) in turns: 1 row 0.076-0.079
// ms (77-80% of the bound; parent 0.090-0.091), 8 rows 0.083 (0.213-0.218),
// 32 rows 0.110-0.111 (61-62%; 0.912-0.923), 48 rows 0.111-0.112
// (1.804-1.819). The ring alone (no mma, no stores) reads 0.073 at 1 row:
// the TMA stream, not the tensor cores or the widen, sets the time there. At
// 32 rows y's 25 MB of writes cost most of the rest (streaming stores took
// 0.136 to 0.115; stores to one L2-resident row read 0.098). nvcc -Xptxas
// -v (sm_90a): six instantiations (1-6 n-tiles) of 159-255 registers, three
// spilling 8-32 bytes.

#include <cuda.h>

#include "common.cuh"
#include "gemv_stack_plan.cuh"
#include "tma.cuh"

namespace {

using namespace pt;

// Seven consumer warps and the producer: two warps per SM sub-partition, so
// 255 registers a thread (nine warps would leave 168).
constexpr int kConsumerWarps = 7;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kBlockThreads = kConsumers + 32;  // and one producer warp
constexpr int kMTiles = kGsTileRows / 16;       // 16-row mma tiles of a warp tile
constexpr int kBoxBytes = 16 * kGsChunk;        // one tensor copy: 16 rows x 128 columns

struct Args {
  const __nv_bfloat16* x;
  const float* s;
  float* y;
  int R, I, O;
  long long N;  // rows of the flat weight, L * O
  GsPlan plan;
};

// The box row that mma row g (0..7) of a 16-row tile reads; row g + 8 reads
// it + 8. Lanes 8q .. 8q + 7 (rows 2q, 2q + 1) then meet swizzle phases q
// and q + 4, which put their 16-byte chunks in opposite halves of the banks.
__device__ __forceinline__ int box_row(int g) { return (g >> 1) | ((g & 1) << 2); }

// A lane's 16 weight bytes as 8 bf16 pairs (bytes 2i, 2i + 1 in pair i),
// exact: the byte's v + 128 under 2^23 in f32, minus 2^23 + 128, is v, whose
// f32 high half is its bf16.
__device__ __forceinline__ void widen(const uint4& u, uint32_t (&o)[8]) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                         u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)  // bytes b, 0, 0, 0x4B: 2^23 + (v + 128)
      f[b] = __float_as_uint(__uint_as_float(__byte_perm(w[i], 0x4B00u, 0x5440u | b)) -
                             8388736.f);
    o[2 * i] = __byte_perm(f[0], f[1], 0x7632u);
    o[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632u);
  }
}

// Pass `pass` of the plan: x rows [r0, r0 + nr) and columns [c0, c0 + nc),
// streamed in `chunks` ring stages per warp tile.
struct Pass {
  int r0, nr, c0, nc, chunks, kp;
  __device__ Pass(const Args& a, int pass) {
    const int grp = pass / a.plan.kpasses;
    kp = pass % a.plan.kpasses;
    r0 = grp * a.plan.rows;
    nr = min(a.plan.rows, a.R - r0);
    c0 = kp * a.plan.kc;
    nc = min(a.plan.kc, a.I - c0);
    chunks = (nc + kGsChunk - 1) / kGsChunk;
  }
};

// The block's span of 16-row tiles [lo, lo + n) in rounds of kConsumerWarps
// warp tiles: warp tile j holds [start(j), start(j + 1)) and goes to warp
// j % kConsumerWarps, so the warps of a round stream adjacent rows. Every
// round but the last has full tiles (kMTiles); the last splits what is left
// evenly, so each warp gets the same share to one 16-row tile. Only there,
// and only when fewer than kConsumerWarps 16-row tiles are left, can a warp
// tile be empty; it then takes no ring stage.
struct Span {
  int lo, n, rounds, rest;  // rest: 16-row tiles of the last round
  __device__ Span(int lo_, int hi_) : lo(lo_), n(hi_ - lo_) {
    rounds = (n + kConsumerWarps * kMTiles - 1) / (kConsumerWarps * kMTiles);
    rest = n - (rounds - 1) * kConsumerWarps * kMTiles;
  }
  __device__ int start(int j) const {
    const int full = (rounds - 1) * kConsumerWarps;
    return j <= full ? lo + j * kMTiles
                     : lo + full * kMTiles + rest * (j - full) / kConsumerWarps;
  }
};

__device__ void produce(const CUtensorMap* wmap, const Args& a, const Span& sp,
                        unsigned char* ring, unsigned char* xs, uint64_t* full, uint64_t* empty,
                        uint64_t* x_full, uint64_t* x_empty) {
  const uint64_t wpol = evict_first_policy(), xpol = evict_last_policy();
  const int S = a.plan.stages;
  int slot = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < a.plan.groups * a.plan.kpasses; ++pass) {
    const Pass ps(a, pass);
    mbar_wait(x_empty, (pass & 1) ^ 1u);  // every warp is done with the last pass's x
    mbar_expect_tx(x_full, static_cast<uint32_t>(ps.nr * ps.nc * 2));
    for (int r = 0; r < ps.nr; ++r)
      bulk_load(xs + static_cast<size_t>(r) * a.plan.x_stride,
                a.x + static_cast<size_t>(ps.r0 + r) * a.I + ps.c0,
                static_cast<uint32_t>(ps.nc * 2), x_full, xpol);
    for (int q = 0; q < sp.rounds; ++q) {
      int b[kConsumerWarps + 1];  // the round's warp tiles, in 16-row tiles
#pragma unroll
      for (int v = 0; v <= kConsumerWarps; ++v) b[v] = sp.start(q * kConsumerWarps + v);
      for (int c = 0; c < ps.chunks; ++c) {
        const int col = ps.c0 + c * kGsChunk;
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) {
          const int boxes = b[w + 1] - b[w];
          if (boxes == 0) continue;
          mbar_wait(&empty[slot], phase ^ 1u);
          mbar_expect_tx(&full[slot], static_cast<uint32_t>(boxes * kBoxBytes));
          unsigned char* dst = ring + static_cast<size_t>(slot) * kGsStageBytes;
          for (int m = 0; m < boxes; ++m)
            tensor_load_2d(dst + m * kBoxBytes, wmap, col, (b[w] + m) * 16, &full[slot], wpol);
          if (++slot == S) {
            slot = 0;
            phase ^= 1u;
          }
        }
      }
    }
  }
}

// The block's shared-memory layout and the lane, as a consumer sees them.
struct Block {
  unsigned char* ring;
  const unsigned char* xs;
  uint64_t *full, *empty;
  int stages, lane;
};

// One warp tile of M 16-row tiles from 16-row tile mt on, in pass ps: its
// ring stages are st, st + nw, st + 2 nw, ... of the producer's order.
template <int NT, int M>
__device__ __forceinline__ void tile(const Args& a, const Pass& ps, const Block& blk, int mt,
                                    unsigned st, int nw) {
  const int S = blk.stages, lane = blk.lane, g = lane / 4, t = lane % 4;
  const int brow = box_row(g), row0 = mt * 16;
  // the epilogue's share of this lane: 4 rows from row0 + 4 * (lane % 16)
  const int erow = row0 + 4 * (lane % 16);
  const bool ein = lane % 16 < 4 * M;
  const bool evec = ein && a.O % 4 == 0 && erow + 3 < a.N;  // 16-byte stores
  const bool last = ps.kp == a.plan.kpasses - 1;
  float4 s4 = make_float4(1.f, 1.f, 1.f, 1.f);  // the rows' scales, fetched before the stream
  if (last && evec) s4 = __ldg(reinterpret_cast<const float4*>(a.s + erow));
  float acc[M][NT][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;

  int slot = static_cast<int>(st % S);
  uint32_t phase = (st / S) & 1u;
  for (int c = 0; c < ps.chunks; ++c) {
    // Warps run at their own pace, so the slot's last occupant (stage
    // st - S, another warp's) is awaited first: then the full barrier's
    // parity names stage st and not the one before it. Both waits are at
    // most one phase behind, as a parity wait must be: this warp's previous
    // stage is at least st - S (st - nw within a round, at most that across
    // rounds: only the last round can leave warps out; a new pass starts
    // once every stage of the last is consumed) and consumed, so every stage
    // up to it was issued and stage st - 2S consumed.
    if (st >= static_cast<unsigned>(S)) mbar_wait(&blk.empty[slot], phase ^ 1u);
    mbar_wait(&blk.full[slot], phase);
    const unsigned char* stage = blk.ring + static_cast<size_t>(slot) * kGsStageBytes;
#pragma unroll 1
    for (int j = 0; j < 2; ++j) {  // the stage's two 64-column slabs, one at a time (registers)
      const int col = c * kGsChunk + j * 64 + t * 16;  // the lane's 16 k, within the pass
      uint32_t b[NT][8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
        if (col < ps.nc) {  // I % 16 == 0: the lane's 16 are all in or all out
          const uint4* xp = reinterpret_cast<const uint4*>(
              blk.xs + static_cast<size_t>(n * 8 + g) * a.plan.x_stride + col * 2);
          u0 = xp[0];
          u1 = xp[1];
        }
        b[n][0] = u0.x; b[n][1] = u0.y; b[n][2] = u0.z; b[n][3] = u0.w;
        b[n][4] = u1.x; b[n][5] = u1.y; b[n][6] = u1.z; b[n][7] = u1.w;
      }
      const int chunk = ((j * 4 + t) ^ brow) * 16;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const unsigned char* wrow = stage + (m * 16 + brow) * kGsChunk + chunk;
        uint32_t lo[8], hi[8];
        widen(*reinterpret_cast<const uint4*>(wrow), lo);
        widen(*reinterpret_cast<const uint4*>(wrow + 8 * kGsChunk), hi);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            mma_bf16(acc[m][n], lo[2 * k], hi[2 * k], lo[2 * k + 1], hi[2 * k + 1],
                     b[n][2 * k], b[n][2 * k + 1]);
      }
    }
    if (c == ps.chunks - 1) break;  // the last stage stays this warp's for the epilogue
    __syncwarp();
    if (lane == 0) mbar_arrive(&blk.empty[slot]);  // the warp is done with the stage
    st += nw;
    slot += nw;
    if (slot >= S) {
      slot -= S;
      phase ^= 1u;
    }
  }

  // Epilogue through the tile's last stage, 4 n-tiles (32 rows of x) at a
  // time: the C fragments (row g, x rows 2t, 2t + 1, then row g + 8) go to
  // shared memory as [x row][64 weight rows] f32, the 16-byte chunks of an x
  // row swizzled by its bits 1-2 so that the warp's stores meet no bank
  // twice; then each lane takes 4 consecutive weight rows (o) of one x row,
  // so a warp store writes two 256-byte runs of y instead of 32-byte pieces.
  // A row of the flat weight is (l, o) = (row / O, row % O); with O % 4 == 0
  // four rows from a multiple of 4 share l and one 16-byte store.
  float* sy = reinterpret_cast<float*>(blk.ring + static_cast<size_t>(slot) * kGsStageBytes);
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += 4) {
    __syncwarp();  // the stage's weights, or the last half's sums, are read
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = n0; n < min(NT, n0 + 4); ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = (n - n0) * 8 + 2 * t + e, row = m * 16 + brow + 8 * h;
            sy[r * 64 + ((((row >> 2) ^ (((r >> 1) & 3) << 1))) << 2) + (row & 3)] =
                acc[m][n][2 * h + e];
          }
    __syncwarp();
    const int rows = min(32, ps.nr - n0 * 8);
    for (int r = lane / 16; r < rows; r += 2) {
      if (!ein) continue;
      float4 v = *reinterpret_cast<const float4*>(
          sy + r * 64 + (((lane % 16) ^ (((r >> 1) & 3) << 1)) << 2));
      const long long xr = ps.r0 + n0 * 8 + r;  // the row of x
      if (evec) {
        const int l = erow / a.O;
        float4* dst = reinterpret_cast<float4*>(a.y + (static_cast<long long>(l) * a.R + xr) * a.O +
                                                 (erow - l * a.O));
        if (ps.kp > 0) {  // column passes: the partial sum so far
          const float4 old = *dst;
          v = make_float4(old.x + v.x, old.y + v.y, old.z + v.z, old.w + v.w);
        }
        __stcs(dst, make_float4(v.x * s4.x, v.y * s4.y, v.z * s4.z, v.w * s4.w));
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int row = erow + k;
          if (row >= a.N) break;
          const int l = row / a.O;
          float* dst = a.y + (static_cast<long long>(l) * a.R + xr) * a.O + (row - l * a.O);
          const float sum = ps.kp > 0 ? *dst + vs[k] : vs[k];
          __stcs(dst, last ? sum * a.s[row] : sum);
        }
      }
    }
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(&blk.empty[slot]);
}

template <int NT>
__global__ void __launch_bounds__(kBlockThreads, 1)
gemv_stack_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int S = a.plan.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kGsMaxStages;
  uint64_t* x_full = empty + kGsMaxStages;
  uint64_t* x_empty = x_full + 1;
  // the ring on a 1024-byte boundary (the swizzle's period), past the
  // mbarriers; then x
  const uint32_t base = smem_u32(smem);
  unsigned char* ring = smem + (((base + 1024u + 1023u) & ~1023u) - base);
  unsigned char* xs = ring + static_cast<size_t>(S) * kGsStageBytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long mtiles = (a.N + 15) / 16;
  const Span sp(static_cast<int>(gs_span_start(blockIdx.x, gridDim.x, mtiles)),
                static_cast<int>(gs_span_start(blockIdx.x + 1, gridDim.x, mtiles)));
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);  // one warp consumes a stage
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    if (lane == 0) produce(&wmap, a, sp, ring, xs, full, empty, x_full, x_empty);
    return;
  }

  const Block blk{ring, xs, full, empty, S, lane};
  unsigned idx = 0;  // ring stages consumed by the block, as the producer counts them
  for (int pass = 0; pass < a.plan.groups * a.plan.kpasses; ++pass) {
    const Pass ps(a, pass);
    mbar_wait(x_full, pass & 1);
    for (int q = 0; q < sp.rounds; ++q) {
      // this warp's tile, the round's warps with a tile and those before this one
      const int j = q * kConsumerWarps + warp;
      const int mt = sp.start(j), mcount = sp.start(j + 1) - mt;
      int nw = kConsumerWarps, before = warp;
      if (q == sp.rounds - 1 && sp.rest < kConsumerWarps) {
        nw = before = 0;
        for (int v = 0; v < kConsumerWarps; ++v) {
          if (sp.start(q * kConsumerWarps + v + 1) == sp.start(q * kConsumerWarps + v)) continue;
          before += v < warp;
          ++nw;
        }
      }
      switch (mcount) {
        case 4: tile<NT, 4>(a, ps, blk, mt, idx + before, nw); break;
        case 3: tile<NT, 3>(a, ps, blk, mt, idx + before, nw); break;
        case 2: tile<NT, 2>(a, ps, blk, mt, idx + before, nw); break;
        case 1: tile<NT, 1>(a, ps, blk, mt, idx + before, nw); break;
        default: break;  // an empty warp tile
      }
      idx += static_cast<unsigned>(ps.chunks * nw);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(x_empty);  // the warp is done with this pass's x
  }
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

template <int NT>
cudaError_t launch(const CUtensorMap& wmap, const Args& a, int grid, int optin, cudaStream_t st) {
  // raised once, to the most a block may take, before any stream capture
  static const cudaError_t allowed = cudaFuncSetAttribute(
      gemv_stack_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (allowed != cudaSuccess) return allowed;
  gemv_stack_kernel<NT><<<grid, kBlockThreads, static_cast<size_t>(a.plan.smem), st>>>(wmap, a);
  return cudaGetLastError();
}

}  // namespace

// x [R, I] bf16, Wq [L, O, I] int8, s [L, O] f32, y [L, R, O] f32, all
// contiguous on the device, x and Wq 16-byte aligned; I a multiple of 16; any
// R >= 1; L <= 65535. One launch on `stream`, on the current device. Returns
// cudaGetLastError(); 1 (cudaErrorInvalidValue) for a case it does not take.
extern "C" int gemv_stack_run(int R, int L, int O, int I, const void* x, const void* Wq,
                              const void* s, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = static_cast<long long>(L) * O;
  // (rows of the flat weight and of its last tile index as int)
  if (R < 1 || L < 1 || L > 65535 || O < 1 || I < 16 || I % 16 || N > 0x7fffffffLL - 64)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (optin > 227 * 1024) optin = 227 * 1024;
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(s),
         static_cast<float*>(y), R, I, O, N, gs_plan(R, I, optin)};
  if (a.plan.smem == 0 || a.plan.nt > kGsMaxGroup / 8) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the flat weight [N, I] as a 2-D tensor of bytes, 16 x 128 boxes
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(I), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(I)};
  const cuuint32_t box[2] = {kGsChunk, 16};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(Wq), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const long long mtiles = (N + 15) / 16;
  const int grid = static_cast<int>(mtiles < sms ? mtiles : sms);
  static_assert(kGsMaxGroup <= 48, "one kernel per n-tile count, up to six");
  switch (a.plan.nt) {
    case 1: return launch<1>(wmap, a, grid, optin, st);
    case 2: return launch<2>(wmap, a, grid, optin, st);
    case 3: return launch<3>(wmap, a, grid, optin, st);
    case 4: return launch<4>(wmap, a, grid, optin, st);
    case 5: return launch<5>(wmap, a, grid, optin, st);
    default: return launch<6>(wmap, a, grid, optin, st);
  }
}
