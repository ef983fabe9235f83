// The whole SEANet decoder program on [B, C0, T0] -> [B, 1, T0 * prod(ratios)].
//
// Replaces the Pallas kernel pocket_tts_tpu/ops/codec_decode.py
// (seanet_decoder_fused / _build_kernel). One C call runs the op program the
// wrapper lays out (ops/codec_decode.py): one launch per stride-1 conv and per
// K = 2S transposed conv, with
//   * the ELU that precedes a conv fused into that conv's input staging,
//   * the residual add of a block fused into its last conv's epilogue,
//   * the streaming state read and written by the op that owns it: a conv's
//     left context (the last K_eff - 1 samples of its input window) and a
//     transposed conv's overlap-add tail (with the bias taken back out).
//
// Bound on the H100. Per 16-position frame and row the flagship decoder does
// ~324 MFLOP over ~8 MB of bf16 weights, and each conv's output makes a
// device-memory round trip: ~2.1 MB per row-frame. At B = 1 the weight bytes
// bind (8 MB at 3.35 TB/s: ~2.4 us against ~0.3 us of bf16 operations). From
// B = 32 the operations and the activation bytes bind together: a b128
// request (100 frames per row) moves ~27 GB of activations, ~8 ms, against
// ~4.2 ms of bf16 operations at the 989 TFLOP/s peak.
//
// bf16 (every serving path): tensor cores. Each op is one implicit GEMM,
// D[m, n] = sum_k sum_ci A_k[m, ci] * win[ci, n + k * dil], with
//   * M the output channels (conv) or S * Cout phase rows m = co * S + r
//     (transposed conv: y[t S + r] = W[:, :, r] x[t] + W[:, :, r + S] x[t-1]
//     is a 2-tap stride-1 product per phase; its position Tn is the new tail;
//     at t = 0 the x[-1] term is the carried tail, added in the epilogue),
//   * N the output positions of all rows of the batch, flattened, so that
//     short inputs still fill a tile (B = 32, T0 = 16: N = 512 at the stem),
//   * the reduction over taps x Cin, with no im2col: A_k is the weights as
//     the wrapper packs them once per model ([K, M_pad, Cin_pad], Cin
//     contiguous), and the B operand of every tap is the same input tile in
//     shared memory, read k * dil rows further on. An N tile that spans
//     rows of the batch stages each row's window segment with its own halo.
// mma.sync.m16n8k16 (bf16 in, f32 sums) on fragments read from shared memory.
// The weight tiles stream through a cp.async ring; the input tile (transposed
// to [position][Cin], the pending ELU applied and rounded to bf16 as it is
// stored) through a register prefetch one chunk ahead into a double buffer,
// since the transpose and the ELU cannot ride on cp.async. Each thread stages
// one shared row (a window sample) and every tpr-th channel pair of it, with
// branch-free loads, so that all of a chunk's loads are in flight together.
//
// The tile is chosen per op from its shape (run_tc): the largest whose rows
// are not mostly padding, whose window and ring fit, and that gives at least
// 100 blocks. 128 x 128 (16 warps of 32 x 32, 64-channel chunks) takes the
// transposed convs and the 128- and 256-row convs at B >= 32; 64 x 128 the
// stem and the 64-row convs; 32 x 128 the 32-row and 1-row convs; 32 x 64
// (2 warps split the reduction) the mid-sized ops at B = 32, T0 = 16;
// 16 x 16 (8 warps split the reduction) every op at B = 1, with its whole
// input window resident, a 6-stage weight ring and a launch that may begin
// while the previous op drains (programmatic dependent launch: the first
// weight chunks are in flight before the wait), so that the stem's 3.7 MB of
// weights stream through 32 blocks and the first transposed conv's through
// 192. Split sums
// meet in shared memory in a fixed order (no atomics), where every thread
// then finishes one output. Channels pad with zeros to the tile (the packing
// pads M to 16 and Cin to 32), so the final 64 -> 1 conv and the small
// configs' narrow convs run the same body.
//
// Measured (chip_smoke.py, device time by graph replay; H100 80GB HBM3 at
// 700 W): the english.yaml decoder at B = 1, T0 = 16 in 0.100 ms, at B = 32,
// T0 = 16 in 0.487 ms (the first design, by a host-launched loop: 0.50 and
// 3.53), at B = 128, T0 = 512 in 32.3 ms, ~41 TFLOP/s or ~4% of the
// operations bound. What holds it back: at B = 1 each launch's
// chain of dependent round trips (the window, the first weight chunks, the
// split-sum meeting, the stores), 5-13 us an op; from B = 32 the per-chunk
// barrier with a one-chunk-ahead prefetch, the input staging and its ELU,
// which every M tile repeats, and the scattered 2-byte stores of the
// transposed convs' phases. wgmma with TMA-fed operands, a deeper input
// pipeline and a fused residual block are later work.
//
// f32 (the CPU-parity and f32 paths, bar 1e-4): the CUDA-core body, one
// output channel group per thread row, f32 FMAs from 32-channel shared-memory
// tiles of the torch-layout weights, unchanged from the first design.
//
// Which body an op takes is fixed by its dtype (bf16: tensor cores, f32: CUDA
// cores) and its tile by its shape; the C entry reports both per op.
//
// Numerics follow nn/conv.py: f32 accumulation, each conv's result rounded to
// the working dtype, the bias added in that dtype, ELU computed in f32 and
// rounded (the bf16 body's ELU is elu_fast, below), the residual and overlap
// adds rounded.

#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace pt;

constexpr int kTT = 32;      // time steps (or output positions) per block
constexpr int kGroups = 8;   // channel groups per block (blockDim.y)
constexpr int kCiTile = 32;  // input channels staged per pass

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

// Input sample of a conv's window [ctx + Tn): the carried context, then the
// (ELU-ed) new input.
template <typename T>
__device__ __forceinline__ float window_at(const T* x, const T* s_in, int ctx, int Tn,
                                           int elu_in, int j) {
  if (j < ctx) return to_f<T>(s_in[j]);
  const float v = to_f<T>(x[j - ctx]);
  return elu_in ? round_t<T>(elu(v)) : v;
}

// y[b, co, t] = sum_ci sum_k w[co, ci, k] * win[b, ci, t + k*dil] (+ bias)
// (+ res[b, co, t]); x [B, Cin, Tn], s_in/s_out [B, Cin, ctx], w [Cout, Cin, K].
template <typename T, int RCO>
__global__ void __launch_bounds__(kTT * kGroups)
conv_kernel(const T* __restrict__ x, const T* __restrict__ s_in, T* __restrict__ s_out,
            const T* __restrict__ w, const T* __restrict__ bias, const T* __restrict__ res,
            T* __restrict__ y, int Cin, int Cout, int K, int dil, int ctx, int Tn,
            int elu_in) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TCO = kGroups * RCO;
  const int WIN = kTT + ctx;
  float* sx = smem;                   // [kCiTile][WIN]
  float* sw = smem + kCiTile * WIN;   // [TCO][kCiTile][K]
  const int b = blockIdx.z, t0 = blockIdx.x * kTT, co0 = blockIdx.y * TCO;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTT + tx;
  const T* xb = x + static_cast<size_t>(b) * Cin * Tn;
  const T* sb = ctx ? s_in + static_cast<size_t>(b) * Cin * ctx : nullptr;

  if (ctx && blockIdx.x == 0 && blockIdx.y == 0) {  // new context: the window's last ctx
    for (int idx = tid; idx < Cin * ctx; idx += kTT * kGroups) {
      const int ci = idx / ctx, j = idx % ctx;
      s_out[static_cast<size_t>(b) * Cin * ctx + idx] =
          from_f<T>(window_at<T>(xb + static_cast<size_t>(ci) * Tn, sb + ci * ctx, ctx, Tn,
                                 elu_in, Tn + j));
    }
  }

  float acc[RCO];
#pragma unroll
  for (int r = 0; r < RCO; ++r) acc[r] = 0.f;
  for (int ci0 = 0; ci0 < Cin; ci0 += kCiTile) {
    const int nci = min(kCiTile, Cin - ci0);
    for (int idx = tid; idx < kCiTile * WIN; idx += kTT * kGroups) {
      const int c = idx / WIN, j = t0 + idx % WIN;
      float v = 0.f;
      if (c < nci && j < ctx + Tn)
        v = window_at<T>(xb + static_cast<size_t>(ci0 + c) * Tn,
                         ctx ? sb + (ci0 + c) * ctx : nullptr, ctx, Tn, elu_in, j);
      sx[idx] = v;
    }
    for (int idx = tid; idx < TCO * kCiTile * K; idx += kTT * kGroups) {
      const int co = idx / (kCiTile * K), c = (idx / K) % kCiTile, k = idx % K;
      float v = 0.f;
      if (co0 + co < Cout && c < nci)
        v = to_f<T>(w[(static_cast<size_t>(co0 + co) * Cin + ci0 + c) * K + k]);
      sw[idx] = v;
    }
    __syncthreads();
    for (int c = 0; c < nci; ++c) {
      for (int k = 0; k < K; ++k) {
        const float xv = sx[c * WIN + tx + k * dil];
#pragma unroll
        for (int r = 0; r < RCO; ++r)
          acc[r] = fmaf(sw[((ty * RCO + r) * kCiTile + c) * K + k], xv, acc[r]);
      }
    }
    __syncthreads();
  }

  const int t = t0 + tx;
  if (t >= Tn) return;
#pragma unroll
  for (int r = 0; r < RCO; ++r) {
    const int co = co0 + ty * RCO + r;
    if (co >= Cout) continue;
    float v = round_t<T>(acc[r]);
    if (bias) v = round_t<T>(v + to_f<T>(bias[co]));
    const size_t o = (static_cast<size_t>(b) * Cout + co) * Tn + t;
    if (res) v = round_t<T>(to_f<T>(res[o]) + v);
    y[o] = from_f<T>(v);
  }
}

// Transposed conv with K = 2S over x [B, Cin, Tn], w [Cin, Cout, K]. Full
// output position p in [0, Tn*S + S) takes input steps p/S (tap p%S) and
// p/S - 1 (tap p%S + S). Emitted: p < Tn*S, the first S overlap-added with
// the carried tail s_in [B, Cout, S]; p >= Tn*S is the new tail (bias out).
template <typename T, int RCO>
__global__ void __launch_bounds__(kTT * kGroups)
convtr_kernel(const T* __restrict__ x, const T* __restrict__ s_in, T* __restrict__ s_out,
              const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ y,
              int Cin, int Cout, int S, int Tn, int elu_in) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TCO = kGroups * RCO;
  const int K = 2 * S;
  const int NT = kTT / S + 3;          // input steps a block's positions touch
  float* sx = smem;                    // [kCiTile][NT]
  float* sw = smem + kCiTile * NT;     // [kCiTile][TCO][K]
  const int b = blockIdx.z, p0 = blockIdx.x * kTT, co0 = blockIdx.y * TCO;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTT + tx;
  const int tbase = p0 / S - 1;
  const T* xb = x + static_cast<size_t>(b) * Cin * Tn;
  const int p = p0 + tx;
  const int t1 = p / S, k1 = p - t1 * S;

  float acc[RCO];
#pragma unroll
  for (int r = 0; r < RCO; ++r) acc[r] = 0.f;
  for (int ci0 = 0; ci0 < Cin; ci0 += kCiTile) {
    const int nci = min(kCiTile, Cin - ci0);
    for (int idx = tid; idx < kCiTile * NT; idx += kTT * kGroups) {
      const int c = idx / NT, t = tbase + idx % NT;
      float v = 0.f;
      if (c < nci && t >= 0 && t < Tn) {
        v = to_f<T>(xb[static_cast<size_t>(ci0 + c) * Tn + t]);
        if (elu_in) v = round_t<T>(elu(v));
      }
      sx[idx] = v;
    }
    for (int idx = tid; idx < kCiTile * TCO * K; idx += kTT * kGroups) {
      const int c = idx / (TCO * K), co = (idx / K) % TCO, k = idx % K;
      float v = 0.f;
      if (co0 + co < Cout && c < nci)
        v = to_f<T>(w[(static_cast<size_t>(ci0 + c) * Cout + co0 + co) * K + k]);
      sw[idx] = v;
    }
    __syncthreads();
    for (int c = 0; c < nci; ++c) {
      const float xa = sx[c * NT + t1 - tbase];      // step t1, tap k1
      const float xb1 = sx[c * NT + t1 - 1 - tbase]; // step t1 - 1, tap k1 + S
#pragma unroll
      for (int r = 0; r < RCO; ++r) {
        const float* wr = sw + (c * TCO + ty * RCO + r) * K;
        acc[r] = fmaf(wr[k1], xa, fmaf(wr[k1 + S], xb1, acc[r]));
      }
    }
    __syncthreads();
  }

  const int full = Tn * S + S;
  if (p >= full) return;
#pragma unroll
  for (int r = 0; r < RCO; ++r) {
    const int co = co0 + ty * RCO + r;
    if (co >= Cout) continue;
    float v = round_t<T>(acc[r]);
    const float bv = bias ? to_f<T>(bias[co]) : 0.f;
    if (bias) v = round_t<T>(v + bv);
    const size_t row = static_cast<size_t>(b) * Cout + co;
    if (p < Tn * S) {
      if (p < S) v = round_t<T>(v + to_f<T>(s_in[row * S + p]));
      y[row * Tn * S + p] = from_f<T>(v);
    } else {
      s_out[row * S + (p - Tn * S)] = from_f<T>(bias ? round_t<T>(v - bv) : v);
    }
  }
}

// One op of the program, as the wrapper packs it: 17 int64 fields. `w` is the
// torch-layout weight (the CUDA-core body's), `wp` the packed one (the tensor
// cores'): [K, M_pad, Cin_pad] for a conv, [2, M_pad, Cin_pad] for a
// transposed conv (tap 0 takes x[t - 1], tap 1 x[t]; row m = co * S + r).
struct Op {
  long long kind;  // 0 = stride-1 conv, 1 = transposed conv (K = 2S)
  long long cin, cout, k, stride, dil, ctx, elu_in, t_in;
  long long x, y, w, b, s_in, s_out, res, wp;  // device pointers (0 = none)
};

template <typename T, int RCO>
cudaError_t launch(const Op& op, int B, cudaStream_t s) {
  const dim3 block(kTT, kGroups);
  const int TCO = kGroups * RCO;
  const int Tn = static_cast<int>(op.t_in);
  const T* x = reinterpret_cast<const T*>(op.x);
  const T* w = reinterpret_cast<const T*>(op.w);
  const T* b = reinterpret_cast<const T*>(op.b);
  const T* s_in = reinterpret_cast<const T*>(op.s_in);
  T* s_out = reinterpret_cast<T*>(op.s_out);
  T* y = reinterpret_cast<T*>(op.y);
  const int Cin = static_cast<int>(op.cin), Cout = static_cast<int>(op.cout);
  const int K = static_cast<int>(op.k);
  cudaError_t e;
  if (op.kind == 0) {
    const int ctx = static_cast<int>(op.ctx);
    const size_t bytes = (kCiTile * (kTT + ctx) + static_cast<size_t>(TCO) * kCiTile * K) *
                         sizeof(float);
    if ((e = allow_smem(conv_kernel<T, RCO>, bytes)) != cudaSuccess) return e;
    const dim3 grid((Tn + kTT - 1) / kTT, (Cout + TCO - 1) / TCO, B);
    conv_kernel<T, RCO><<<grid, block, bytes, s>>>(
        x, s_in, s_out, w, b, reinterpret_cast<const T*>(op.res), y, Cin, Cout, K,
        static_cast<int>(op.dil), ctx, Tn, static_cast<int>(op.elu_in));
  } else {
    const int S = static_cast<int>(op.stride);
    const size_t bytes = (kCiTile * (kTT / S + 3) + static_cast<size_t>(kCiTile) * TCO * K) *
                         sizeof(float);
    if ((e = allow_smem(convtr_kernel<T, RCO>, bytes)) != cudaSuccess) return e;
    const dim3 grid((Tn * S + S + kTT - 1) / kTT, (Cout + TCO - 1) / TCO, B);
    convtr_kernel<T, RCO><<<grid, block, bytes, s>>>(x, s_in, s_out, w, b, y, Cin, Cout, S,
                                                     Tn, static_cast<int>(op.elu_in));
  }
  return cudaGetLastError();
}

// four output channels per thread, unless that leaves fewer than two blocks
// per SM of the H100's 132 (short inputs): then one
cudaError_t run_cuda_cores(int B, const Op& op, cudaStream_t s) {
  const long long t_out = op.kind ? op.t_in * op.stride + op.stride : op.t_in;
  const long long blocks4 =
      (t_out + kTT - 1) / kTT * ((op.cout + 4 * kGroups - 1) / (4 * kGroups)) * B;
  return blocks4 < 2 * 132 ? launch<float, 1>(op, B, s) : launch<float, 4>(op, B, s);
}

// ------------------------------------------------------------ tensor cores

using bf16 = __nv_bfloat16;

constexpr int kPf = 16;          // channel pairs a thread prefetches per chunk
constexpr int kMAlign = 16;      // the packing's padding of M and Cin (ops/codec_decode.py)
constexpr int kCinAlign = 32;
constexpr int kSmemMax = 227 * 1024;

// One GEMM as the tensor-core body sees it. The input window of row b is
// [ctx_in[b] (ctx samples, or zeros without ctx_in) | ELU?(x[b]) (Tn) | zeros];
// output position p of row b (P of them) reads window samples p + k * dil.
struct Gemm {
  const bf16* x;
  const bf16* ctx_in;   // [B, Cin, ctx] or null
  bf16* ctx_out;        // conv: the new context [B, Cin, ctx], or null
  const bf16* w;        // packed [K, m_pad, cin_pad]
  const bf16* bias;     // [Cout] or null
  const bf16* res;      // conv: residual [B, Cout, Tn], or null
  bf16* y;
  const bf16* tail_in;  // transposed conv: [B, Cout, S]
  bf16* tail_out;
  int B, Cin, cin_pad, Cout, M, m_pad, K, dil, ctx, Tn, P, S, elu_in;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ unsigned short raw_bf16(const bf16* p, size_t i) {
  return __ldg(reinterpret_cast<const unsigned short*>(p) + i);
}

// ELU in f32 for the bf16 body, whose result is rounded to bf16: near zero
// expm1 by its Taylor series to v^5 (truncation below 2e-9 of |v| for
// |v| < 1/16), else __expf(v) - 1 (relative error below 4e-6 there). Both
// round to expm1f's bf16 value but for rare inputs, by one unit then;
// expm1f itself cost more than a chunk's products.
__device__ __forceinline__ float elu_fast(float v) {
  if (v > 0.f) return v;
  if (v > -0.0625f)
    return v * (1.f + v * (0.5f + v * (1.f / 6.f + v * (1.f / 24.f + v * (1.f / 120.f)))));
  return __expf(v) - 1.f;
}

// A read-only load (ld.global.nc) widened to f32.
__device__ __forceinline__ float ldg_f(const bf16* p, size_t i) {
  return __bfloat162float(__ushort_as_bfloat16(raw_bf16(p, i)));
}

__device__ __forceinline__ uint32_t elu_pair(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(elu_fast(__low2float(h)), elu_fast(__high2float(h)));
}

// Window sample w of channel ci of row b, raw bf16 bits; *is_x says whether it
// came from x (and so takes the pending ELU).
__device__ __forceinline__ unsigned short window_raw(const Gemm& g, int b, int ci, int w,
                                                     bool* is_x) {
  if (ci >= g.Cin) return 0;
  if (w < g.ctx)
    return g.ctx_in ? raw_bf16(g.ctx_in, (static_cast<size_t>(b) * g.Cin + ci) * g.ctx + w) : 0;
  if (w - g.ctx < g.Tn) {
    *is_x = true;
    return raw_bf16(g.x, (static_cast<size_t>(b) * g.Cin + ci) * g.Tn + w - g.ctx);
  }
  return 0;
}

// Block tile BM x BN = (16 MT WM) x (8 NT WN) of 8 warps; WK of them split
// each chunk's (tap, 16-channel step) pairs. BK input channels per chunk;
// STAGES weight chunks in the cp.async ring. RES: the whole input window
// (every chunk) is staged once up front and stays resident, so the chunk loop
// waits on the weight ring only (the B = 1 tile, whose chain of dependent
// round trips per chunk would otherwise set its time); else the input goes
// through a register prefetch into two buffers, one chunk ahead.
template <int MT_, int NT_, int WM_, int WN_, int WK_, int BK_, int STAGES_, bool RES_>
struct Tile {
  static constexpr int MT = MT_, NT = NT_, WM = WM_, WN = WN_, WK = WK_, BK = BK_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool RES = RES_;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  static constexpr int PITCH = BK + 8;  // bf16 per shared row: conflict-free fragments
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int MINB = THREADS <= 256 ? 2 : 1;  // blocks per SM: <= 128 registers
  static_assert(BK % kCinAlign == 0 || kCinAlign % BK == 0, "chunks tile Cin_pad");
};

template <typename TL>
__global__ void __launch_bounds__(TL::THREADS, TL::MINB)
conv_tc_kernel(const Gemm g, int rows_cap) {
  constexpr int MT = TL::MT, NT = TL::NT, WM = TL::WM, WN = TL::WN, WK = TL::WK, BK = TL::BK;
  constexpr int BM = TL::BM, BN = TL::BN, PITCH = TL::PITCH, KSTEPS = BK / 16;
  constexpr int STAGES = TL::STAGES, THREADS = TL::THREADS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int K = g.K, halo = (K - 1) * g.dil;
  const int stage_elems = K * BM * PITCH;
  const int nchunks = (g.cin_pad + BK - 1) / BK;
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);  // [STAGES][K][BM][PITCH]
  bf16* sx = ring + STAGES * stage_elems;         // [RES ? nchunks : 2][rows_cap][PITCH]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int wk = warp % WK, wm = (warp / WK) % WM, wn = warp / (WK * WM);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int NN = g.B * g.P;

  // The tile's window: one segment per row of the batch it touches, each the
  // row's positions [pa, pb) plus the halo, laid end to end in shared rows.
  const int b_first = n0 / g.P, b_last = (min(n0 + BN, NN) - 1) / g.P;
  const int pa0 = n0 - b_first * g.P;
  auto seg_start = [&](int b) {
    return b == b_first ? 0 : (g.P - pa0 + halo) + (b - b_first - 1) * (g.P + halo);
  };
  auto seg_pa = [&](int b) { return b == b_first ? pa0 : 0; };
  const int rows = seg_start(b_last) + min(g.P, n0 + BN - b_last * g.P) - seg_pa(b_last) + halo;

  // Staging: tpr threads per shared row, each with its row's window sample (a
  // channel-0 pointer and the channel stride; null for zeros) and every
  // tpr-th channel pair. The loads carry no branch, so all of a round's are
  // in flight together.
  const int tpr = max(1, THREADS / rows);  // host: rows <= THREADS
  const int my_row = tid / tpr, part = tid % tpr;
  const bf16* src = nullptr;
  int cstride = 0;
  bool elu_row = false;
  if (my_row < rows) {
    int b = b_first;
    while (b < b_last && my_row >= seg_start(b + 1)) ++b;
    const int w = seg_pa(b) + my_row - seg_start(b);
    if (w < g.ctx) {
      if (g.ctx_in) {
        src = g.ctx_in + static_cast<size_t>(b) * g.Cin * g.ctx + w;
        cstride = g.ctx;
      }
    } else if (w - g.ctx < g.Tn) {
      src = g.x + static_cast<size_t>(b) * g.Cin * g.Tn + w - g.ctx;
      cstride = g.Tn;
      elu_row = g.elu_in;
    }
  }
  uint32_t pf[kPf];
  // round r of the channel pairs [c0, c0 + 2 npairs): pair part + (r kPf + q) tpr
  auto load = [&](int c0, int npairs, int r) {
#pragma unroll
    for (int q = 0; q < kPf; ++q) {
      const int cp = part + (r * kPf + q) * tpr, ci = c0 + 2 * cp;
      const bool any = src != nullptr && cp < npairs;
      const uint32_t lo = any && ci < g.Cin ? raw_bf16(src, static_cast<size_t>(ci) * cstride) : 0u;
      const uint32_t hi =
          any && ci + 1 < g.Cin ? raw_bf16(src, static_cast<size_t>(ci + 1) * cstride) : 0u;
      pf[q] = lo | (hi << 16);
    }
  };
  // ... stored at channel column `col0 + 2 cp` of the slots [col / BK]
  auto store = [&](int col0, int npairs, int r) {
    if (my_row >= rows) return;
#pragma unroll
    for (int q = 0; q < kPf; ++q) {
      const int cp = part + (r * kPf + q) * tpr, col = col0 + 2 * cp;
      if (cp < npairs)
        *reinterpret_cast<uint32_t*>(sx + ((col / BK) * rows_cap + my_row) * PITCH + col % BK) =
            elu_row ? elu_pair(pf[q]) : pf[q];
    }
  };

  // the shared row of each column this lane reads as B (column g of each n-tile)
  int cbase[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + wn * 8 * NT + nt * 8 + gq;
    const int b = n / g.P;
    cbase[nt] = n < NN ? seg_start(b) + n - b * g.P - seg_pa(b) : 0;
  }

  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  auto fetch = [&](int c) {  // chunk c's weights, all taps, into stage c % STAGES
    if (c < nchunks) {
      constexpr int Q = BK / 8;  // 16-byte copies per row
      const int c0 = c * BK;
      const uint32_t st = ring_s + (c % STAGES) * stage_elems * 2;
      for (int i = tid; i < K * BM * Q; i += THREADS) {
        const int k = i / (BM * Q), m = (i / Q) % BM, q = i % Q;
        const bool ok = m0 + m < g.m_pad && c0 + q * 8 < g.cin_pad;
        const bf16* wsrc =
            ok ? g.w + (static_cast<size_t>(k) * g.m_pad + m0 + m) * g.cin_pad + c0 + q * 8 : g.w;
        cp_async16<false>(st + ((k * BM + m) * PITCH + q * 8) * 2, wsrc, ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // One output: the f32 sum of channel co (phase r) at position p of row b,
  // with nn/conv.py's rounding points; bv is co's bias (0 without).
  auto emit = [&](int b, int p, int co, int r, float sum, float bv) {
    float v = round_t<bf16>(sum);
    if (g.bias) v = round_t<bf16>(v + bv);
    const size_t row = static_cast<size_t>(b) * g.Cout + co;
    if (g.S == 0) {  // conv: y[b, co, p] (+ residual)
      if (g.res) v = round_t<bf16>(ldg_f(g.res, row * g.Tn + p) + v);
      g.y[row * g.Tn + p] = __float2bfloat16(v);
    } else if (p < g.Tn) {  // transposed conv: phase r of channel co at step p
      if (p == 0) v = round_t<bf16>(v + ldg_f(g.tail_in, row * g.S + r));
      g.y[row * g.Tn * g.S + static_cast<size_t>(p) * g.S + r] = __float2bfloat16(v);
    } else {  // step Tn: the new tail, bias taken back out
      g.tail_out[row * g.S + r] = __float2bfloat16(g.bias ? round_t<bf16>(v - bv) : v);
    }
  };

  // epilogue (WK == 1): each lane's 2 NT columns and 2 MT rows are resolved
  // once (row of the batch and position, channel, phase, bias).
  auto epilogue = [&]() {
    int colb[NT][2], colp[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn * 8 * NT + nt * 8 + 2 * tq + e;
        colb[nt][e] = n < NN ? n / g.P : -1;
        colp[nt][e] = n - colb[nt][e] * g.P;
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 16 * MT + mt * 16 + gq + 8 * h;
        if (m >= g.M) continue;
        const int co = g.S ? m / g.S : m, r = m - co * max(g.S, 1);
        const float bv = g.bias ? ldg_f(g.bias, co) : 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = colb[nt][e], p = colp[nt][e];
            if (b < 0) continue;
            emit(b, p, co, r, acc[mt][nt][2 * h + e], bv);
          }
      }
    }
  };

  // The weights do not depend on the previous op: their first chunks are
  // in flight before this grid waits for that op (programmatic dependent
  // launch: this grid may start while the previous one drains, and lets the
  // next one start at once).
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // the new conv context: the window's last ctx samples, by every block in turn
  if (g.ctx_out) {
    const int count = g.B * g.Cin * g.ctx;
    const int nthreads = gridDim.x * gridDim.y * THREADS;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * THREADS + tid; i < count;
         i += nthreads) {
      const int b = i / (g.Cin * g.ctx), ci = (i / g.ctx) % g.Cin, j = i % g.ctx;
      bool is_x = false;
      unsigned short r = window_raw(g, b, ci, g.Tn + j, &is_x);
      float v = __bfloat162float(__ushort_as_bfloat16(r));
      if (is_x && g.elu_in) v = elu_fast(v);
      g.ctx_out[i] = __float2bfloat16(v);
    }
  }

  if (TL::RES) {  // every chunk (zeros past Cin), kPf pairs per thread per round
    const int npairs = nchunks * BK / 2;
    const int per_thread = (npairs + tpr - 1) / tpr;
    for (int r = 0; r * kPf < per_thread; ++r) {
      load(0, npairs, r);
      store(0, npairs, r);
    }
  } else {
    load(0, BK / 2, 0);
    store(0, BK / 2, 0);
  }
  for (int c = 0; c < nchunks; ++c) {
    const bool next = !TL::RES && c + 1 < nchunks;
    if (next) load((c + 1) * BK, BK / 2, 0);  // in flight over this chunk's products
    cp_async_wait<STAGES - 2>();              // chunk c's weights have landed
    __syncthreads();  // ... for every thread, and chunk c - 1 is done with by all
    fetch(c + STAGES - 1);
    const bf16* A = ring + (c % STAGES) * stage_elems + (wm * 16 * MT + gq) * PITCH + 2 * tq;
    const bf16* X = sx + (TL::RES ? c : c % 2) * rows_cap * PITCH + 2 * tq;
    for (int pr = wk; pr < K * KSTEPS; pr += WK) {
      const int kt = pr / KSTEPS, kc = (pr % KSTEPS) * 16;
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* ar = A + (kt * BM + mt * 16) * PITCH + kc;
        a[mt][0] = ld32(ar);
        a[mt][1] = ld32(ar + 8 * PITCH);
        a[mt][2] = ld32(ar + 8);
        a[mt][3] = ld32(ar + 8 * PITCH + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* br = X + (cbase[nt] + kt * g.dil) * PITCH + kc;
        b[nt][0] = ld32(br);
        b[nt][1] = ld32(br + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[nt][0], b[nt][1]);
    }
    if (next) store(((c + 1) % 2) * BK, BK / 2, 0);
  }
  cp_async_wait<0>();
  if (WK == 1) {
    epilogue();
    return;
  }
  // One tile, its reduction split over the warps: the partial sums meet in
  // shared memory ([WK][BM][BN + 1], over the spent ring), where every
  // thread adds one output's WK sums in a fixed order and stores it,
  // neighbouring threads on neighbouring positions. (A single warp's
  // epilogue waited on one residual load after another.)
  __syncthreads();  // every warp is done with the ring and the input tiles
  float* red = reinterpret_cast<float*>(tc_smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ml = wm * 16 * MT + mt * 16 + gq + 8 * (c / 2);
        const int nl = wn * 8 * NT + nt * 8 + 2 * tq + c % 2;
        red[(wk * BM + ml) * (BN + 1) + nl] = acc[mt][nt][c];
      }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int ml = i / BN, nl = i % BN, m = m0 + ml, n = n0 + nl;
    if (m >= g.M || n >= NN) continue;
    float sum = red[ml * (BN + 1) + nl];
    for (int o = 1; o < WK; ++o) sum += red[(o * BM + ml) * (BN + 1) + nl];
    const int b = n / g.P, co = g.S ? m / g.S : m;
    emit(b, n - b * g.P, co, m - co * max(g.S, 1), sum,
         g.bias ? ldg_f(g.bias, co) : 0.f);
  }
}

// Rows of the largest input window a BN-wide tile stages: BN positions plus a
// halo for each row of the batch it touches.
int rows_cap(const Gemm& g, int BN) {
  const int segs = std::min(g.B, (BN - 1) / g.P + 2);
  return BN + segs * (g.K - 1) * g.dil;
}

template <typename TL>
size_t smem_bytes(const Gemm& g) {
  const int slots = TL::RES ? (g.cin_pad + TL::BK - 1) / TL::BK : 2;
  const size_t tiles = static_cast<size_t>(TL::STAGES) * g.K * TL::BM * TL::PITCH * 2 +
                       static_cast<size_t>(slots) * rows_cap(g, TL::BN) * TL::PITCH * 2;
  const size_t red = TL::WK > 1 ? static_cast<size_t>(TL::WK) * TL::BM * (TL::BN + 1) * 4 : 0;
  return std::max(tiles, red);
}

constexpr int kMinBlocks = 100;  // a tile shape must give at least this many blocks

// Whether a tile shape takes the op: its input window fits the staging
// (one row per thread at most, and one round of kPf pairs per chunk unless
// resident) and shared memory, and, unless `last`, its rows above 32 are not
// padding and it gives at least kMinBlocks blocks.
template <typename TL>
bool fits(const Gemm& g, bool last) {
  const int rows = rows_cap(g, TL::BN);
  if (rows > TL::THREADS || smem_bytes<TL>(g) > kSmemMax) return false;
  const int tpr = TL::THREADS / rows;
  if (!TL::RES && (TL::BK / 2 + tpr - 1) / tpr > kPf) return false;
  const long long blocks = (static_cast<long long>(g.B) * g.P + TL::BN - 1) / TL::BN *
                           ((g.M + TL::BM - 1) / TL::BM);
  return last || (TL::BM <= std::max(32, g.m_pad) && blocks >= kMinBlocks);
}

// One block per N tile and M tile.
template <typename TL>
cudaError_t launch_tc(const Gemm& g, cudaStream_t s) {
  // raised once, to the most any block takes, before any stream capture
  static const cudaError_t allowed = allow_smem(conv_tc_kernel<TL>, kSmemMax);
  if (allowed != cudaSuccess) return allowed;
  const size_t bytes = smem_bytes<TL>(g);
  const int ntiles = (g.B * g.P + TL::BN - 1) / TL::BN, mtiles = (g.M + TL::BM - 1) / TL::BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntiles, mtiles);
  cfg.blockDim = dim3(TL::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  // only the B = 1 tile: the next op's early blocks would crowd a larger grid's last wave
  attr[0].val.programmaticStreamSerializationAllowed = TL::RES;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, conv_tc_kernel<TL>, g, rows_cap(g, TL::BN));
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The tile shapes, largest first (codes as the C entry reports them):
// 128 x 128 (16 warps of 32 x 32, 64-channel chunks: each staged input tile
// feeds twice the rows, but its 3-stage ring fits shared memory only up to
// K = 3), 64 x 128 (8 warps of 32 x 32), 32 x 128 (8 warps of 16 x 32),
// 32 x 64 (2 warps split the reduction), 16 x 16 (8 warps split it; the input
// resident, a 6-stage weight ring).
enum Body {
  kCudaCores = 0, kTc64x128 = 1, kTc32x64 = 2, kTc16x16 = 3, kTc128x128 = 4, kTc32x128 = 5
};
using TileL = Tile<2, 4, 4, 4, 1, 64, 3, false>;
using TileW = Tile<2, 4, 2, 4, 1, 32, 3, false>;
using TileS = Tile<1, 4, 2, 4, 1, 32, 3, false>;
using TileM = Tile<1, 4, 2, 2, 2, 32, 3, false>;
using TileN = Tile<1, 2, 1, 1, 8, 64, 6, true>;

struct Choice {
  Body body;
  bool (*takes)(const Gemm&, bool);
  cudaError_t (*launch)(const Gemm&, cudaStream_t);
};
constexpr Choice kChoices[] = {{kTc128x128, fits<TileL>, launch_tc<TileL>},
                               {kTc64x128, fits<TileW>, launch_tc<TileW>},
                               {kTc32x128, fits<TileS>, launch_tc<TileS>},
                               {kTc32x64, fits<TileM>, launch_tc<TileM>},
                               {kTc16x16, fits<TileN>, launch_tc<TileN>}};
constexpr int kNumChoices = sizeof(kChoices) / sizeof(kChoices[0]);

// An op takes the first tile that fits, the last one whatever its block count.
// `skip` is a bit mask of Body codes passed over (0 on the serving path; a
// measurement of an op without the tile it would take), the last tile left
// then taking the ops no other fits.
cudaError_t run_tc(const Gemm& g, int skip, int* body, cudaStream_t s) {
  int last = -1;
  for (int i = 0; i < kNumChoices; ++i)
    if (!((skip >> kChoices[i].body) & 1)) last = i;
  for (int i = 0; i <= last; ++i) {
    const Choice& c = kChoices[i];
    if (!((skip >> c.body) & 1) && c.takes(g, i == last)) {
      *body = c.body;
      return c.launch(g, s);
    }
  }
  return cudaErrorInvalidValue;
}

Gemm gemm_of(const Op& op, int B) {
  Gemm g{};
  g.x = reinterpret_cast<const bf16*>(op.x);
  g.w = reinterpret_cast<const bf16*>(op.wp);
  g.bias = reinterpret_cast<const bf16*>(op.b);
  g.y = reinterpret_cast<bf16*>(op.y);
  g.B = B;
  g.Cin = static_cast<int>(op.cin);
  g.cin_pad = (g.Cin + kCinAlign - 1) / kCinAlign * kCinAlign;
  g.Cout = static_cast<int>(op.cout);
  g.Tn = static_cast<int>(op.t_in);
  g.elu_in = static_cast<int>(op.elu_in);
  if (op.kind == 0) {
    g.ctx_in = reinterpret_cast<const bf16*>(op.s_in);
    g.ctx_out = reinterpret_cast<bf16*>(op.s_out);
    g.res = reinterpret_cast<const bf16*>(op.res);
    g.M = g.Cout;
    g.K = static_cast<int>(op.k);
    g.dil = static_cast<int>(op.dil);
    g.ctx = static_cast<int>(op.ctx);
    g.P = g.Tn;
  } else {  // S phase products of 2 taps over [0 | x | 0]; position Tn is the tail
    g.tail_in = reinterpret_cast<const bf16*>(op.s_in);
    g.tail_out = reinterpret_cast<bf16*>(op.s_out);
    g.S = static_cast<int>(op.stride);
    g.M = g.Cout * g.S;
    g.K = 2;
    g.dil = 1;
    g.ctx = 1;
    g.P = g.Tn + 1;
  }
  g.m_pad = (g.M + kMAlign - 1) / kMAlign * kMAlign;
  return g;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every op needs
// its packed weight `wp`). ops: host array of n_ops Op records (17 int64
// each); bodies: host array of n_ops ints, set to the Body code each op ran
// on; skip: Body codes the tile choice passes over (run_tc). Returns
// cudaGetLastError(); 1 (cudaErrorInvalidValue) for an op it does not take.
extern "C" int codec_decode_run(int dtype, int B, int n_ops, const void* ops, int* bodies,
                                int skip, void* stream) {
  const Op* o = static_cast<const Op*>(ops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_ops; ++i) {
    cudaError_t e;
    if (dtype == 0) {
      bodies[i] = kCudaCores;
      e = run_cuda_cores(B, o[i], s);
    } else {
      if (!o[i].wp) return cudaErrorInvalidValue;
      e = run_tc(gemm_of(o[i], B), skip, &bodies[i], s);
    }
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}
