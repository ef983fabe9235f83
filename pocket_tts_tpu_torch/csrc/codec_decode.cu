// The whole SEANet decoder program on [B, C0, T0] -> [B, 1, T0 * prod(ratios)].
//
// Replaces the Pallas kernel pocket_tts_tpu/ops/codec_decode.py
// (seanet_decoder_fused / _build_kernel). One C call runs the op program the
// wrapper lays out (ops/codec_decode.py): one direct-convolution kernel per
// stride-1 conv and per K = 2S transposed conv, with
//   * the ELU that precedes a conv fused into that conv's input load,
//   * the residual add of a block fused into its last conv's epilogue,
//   * the streaming state read and written by the op that owns it: a conv's
//     left context (the last K_eff - 1 samples of its input window) and a
//     transposed conv's overlap-add tail (with the bias taken back out).
//
// Bound on the H100: per frame (T0 = 16) the flagship decoder does ~330 MFLOP
// on ~8 MB of bf16 weights, so at the tensor-core rate the bytes bind (8 MB at
// 3.35 TB/s: ~2.4 us against ~0.3 us of bf16 math); at T0 = 16*K the
// operations grow with K and bind from K of about 8. This first design
// computes on the CUDA cores from tiles in shared memory: a block stages a
// 32-channel slice of its input window and of its weights, then each thread
// accumulates 1 or 4 output channels at one time step in f32. The weights
// (8 MB) do not fit in shared memory but stay in the 50 MB L2 across frames.
// Tensor cores (wgmma) are later work.
//
// Numerics follow nn/conv.py: f32 accumulation, each conv's result rounded to
// the working dtype, the bias added in that dtype, ELU computed in f32 and
// rounded, the residual and overlap adds rounded.

#include <math.h>

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

// One op of the program, as the wrapper packs it: 16 int64 fields.
struct Op {
  long long kind;  // 0 = stride-1 conv, 1 = transposed conv (K = 2S)
  long long cin, cout, k, stride, dil, ctx, elu_in, t_in;
  long long x, y, w, b, s_in, s_out, res;  // device pointers (0 = none)
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

template <typename T>
cudaError_t run(int B, int n_ops, const Op* ops, cudaStream_t s) {
  for (int i = 0; i < n_ops; ++i) {
    // four output channels per thread, unless that leaves fewer than two
    // blocks per SM of the H100's 132 (short inputs): then one
    const Op& op = ops[i];
    const long long t_out = op.kind ? op.t_in * op.stride + op.stride : op.t_in;
    const long long blocks4 = (t_out + kTT - 1) / kTT * ((op.cout + 4 * kGroups - 1) / (4 * kGroups)) * B;
    const cudaError_t e = blocks4 < 2 * 132 ? launch<T, 1>(op, B, s) : launch<T, 4>(op, B, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (activations, weights and states alike).
// ops: host array of n_ops Op records (16 int64 each). Returns cudaGetLastError().
extern "C" int codec_decode_run(int dtype, int B, int n_ops, const void* ops, void* stream) {
  const Op* o = static_cast<const Op*>(ops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run<float>(B, n_ops, o, s) : run<__nv_bfloat16>(B, n_ops, o, s);
}
