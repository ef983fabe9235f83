// Whole FlowLM layer stack for one T=1, B=1 decode step, with the KV append.
//
// Replaces the Pallas kernel pocket_tts_tpu/ops/decode_stack.py
// (decode_stack_tpu / _kernel). Per layer l, on the residual x [D]:
//   h = LN1(x); q,k,v = h @ in_proj[l].T, RoPE on q and k at position `offset`
//   x += Attn(q, cache[l] + the step's own k/v) @ out_proj[l].T
//   h = LN2(x); x += gelu(h @ w1[l].T) @ w2[l].T
// and the new k/v row is written into cache[l] at slot `write_pos`.
//
// Bound on the H100: bytes. At batch 1 every weight is read once per step
// (6 layers x 12.6 M params = 151 MB in bf16 at the flagship shape) against
// ~25 MFLOP, so the step is a stream of matrix-vector products at the memory
// rate (3.35 TB/s: ~45 us). The design serves that: a block owns two weight
// rows and reads them with 16-byte loads issued before it needs them, many
// blocks per SM keep loads in flight, the input vector sits in shared
// memory, and every small op (LN, RoPE, GELU, residual, softmax) is fused
// into a GEMV prologue or epilogue or into the attention kernel, so no
// intermediate makes an extra pass over device memory. One C call launches 5 kernels per layer on the caller's
// stream; fusing the stack into one persistent launch is later work.
//
// int8 rows (weight-only quantization, all four GEMVs or none): the GEMVs
// read 16 int8 values per 16-byte load, halving the weight stream (~75 MB a
// step at the flagship, ~23 us at 3.35 TB/s), and apply each row's f32
// scale in the epilogue at the port's matmul_t rounding points: the f32 sum
// rounded to the working dtype, times the scale, rounded again.
//
// Numerics follow the PyTorch plain version (ops/decode_stack.py), which
// follows the JAX package's XLA scan: f32 accumulation and statistics, every
// op's result rounded to the working dtype, softmax in f32 with its weights
// rounded to the cache dtype before the value sum, exact-erf GELU.
// Masked cache slots are skipped, never multiplied by zero, so a NaN in a
// dead slot cannot leak.

#include <math.h>

#include "common.cuh"

namespace {

using namespace pt;

// GEMV: blocks of 4 warps, each owning RPB weight rows (RoPE rotation pairs
// stay in one block). RPB = 8 when a thread reads one 16-byte chunk per row
// (K = 1024 in bf16), so the block's input prologue (a LayerNorm) is shared
// by 8 rows; RPB = 2 otherwise, which keeps the 1024-row products at 512
// blocks. Each thread issues its kBatch 16-byte loads before it needs any of
// them, and the first batch before the prologue, so the weight stream is in
// flight while the block normalises its input.
constexpr int kGemvThreads = 128;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kBatch = 8;

enum Prologue { kPlainIn = 0, kLayerNorm = 1 };
enum Epilogue { kQkvRope = 0, kResidual = 1, kGelu = 2 };

// Input vector into shared memory as f32; with kLayerNorm, normalised
// (f32 statistics, eps 1e-5) and rounded to T as the plain version does.
template <typename T, int PRO>
__device__ __forceinline__ void load_input(const T* __restrict__ in, int K,
                                           const T* __restrict__ ln_w,
                                           const T* __restrict__ ln_b, float* xin,
                                           float* red) {
  for (int i = threadIdx.x; i < K; i += kGemvThreads) xin[i] = to_f<T>(in[i]);
  __syncthreads();
  if (PRO == kLayerNorm) {
    float s = 0.f;
    for (int i = threadIdx.x; i < K; i += kGemvThreads) s += xin[i];
    const float mean = block_sum<kGemvThreads>(s, red) / static_cast<float>(K);
    float q = 0.f;
    for (int i = threadIdx.x; i < K; i += kGemvThreads) {
      const float d = xin[i] - mean;
      q += d * d;
    }
    const float var = block_sum<kGemvThreads>(q, red) / static_cast<float>(K);
    const float r = rsqrtf(var + 1e-5f);
    for (int i = threadIdx.x; i < K; i += kGemvThreads)
      xin[i] = round_t<T>((xin[i] - mean) * r * to_f<T>(ln_w[i]) + to_f<T>(ln_b[i]));
    __syncthreads();
  }
}

// Epilogue for rows (r, r + 1) with f32 sums (a0, a1): kQkvRope writes q|k|v
// with RoPE on the q and k sections; kResidual adds into `out` (the residual
// stream); kGelu writes gelu(y).
template <typename T, int EPI>
__device__ __forceinline__ void epilogue(T* __restrict__ out, int r, float a0, float a1,
                                         const int* __restrict__ offset, int D, int Dh,
                                         float rope_c) {
  const float y0 = round_t<T>(a0), y1 = round_t<T>(a1);
  if (EPI == kQkvRope) {
    if (r < 2 * D) {  // q or k section: rotate the pair at position offset
      const int j = (r % Dh) / 2;
      const float freq = expf(static_cast<float>(j) * rope_c);
      const float ang = static_cast<float>(*offset) * freq;
      const float c = cosf(ang), s = sinf(ang);
      out[r] = from_f<T>(y0 * c - y1 * s);
      out[r + 1] = from_f<T>(y0 * s + y1 * c);
    } else {
      out[r] = from_f<T>(y0);
      out[r + 1] = from_f<T>(y1);
    }
  } else if (EPI == kResidual) {
    out[r] = from_f<T>(to_f<T>(out[r]) + y0);
    out[r + 1] = from_f<T>(to_f<T>(out[r + 1]) + y1);
  } else {
    const float k = 0.70710678118654752f;
    out[r] = from_f<T>(0.5f * y0 * (1.f + erff(y0 * k)));
    out[r + 1] = from_f<T>(0.5f * y1 * (1.f + erff(y1 * k)));
  }
}

// y = W @ in for a row-major W [rows, K] of type WT (T, or int8 with one f32
// scale per row in `ws`); the block computes rows RPB * b .. RPB * b + RPB - 1.
template <typename T, typename WT, int PRO, int EPI, int RPB>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const T* __restrict__ in, int K, const T* __restrict__ ln_w,
            const T* __restrict__ ln_b, const WT* __restrict__ W, const float* __restrict__ ws,
            int vec_ok, T* __restrict__ out, const int* __restrict__ offset, int D, int Dh,
            float rope_c) {
  static_assert(kBatch % RPB == 0, "a batch covers whole chunks of every row");
  extern __shared__ __align__(16) float smem[];
  float* xin = smem;      // [K]
  float* red = smem + K;  // [kGemvWarps * RPB]
  const int r0 = RPB * blockIdx.x, tid = threadIdx.x;
  const WT* w = W + static_cast<size_t>(r0) * K;
  float acc[RPB];
#pragma unroll
  for (int r = 0; r < RPB; ++r) acc[r] = 0.f;
  if (vec_ok) {
    constexpr int V = Vec16<WT>::n;
    constexpr int CPB = kBatch / RPB;  // chunks per row in one batch
    const int chunks = K / V;          // 16-byte chunks per row
    for (int base = 0; base < chunks; base += CPB * kGemvThreads) {
      uint4 buf[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = base + (b / RPB) * kGemvThreads + tid;
        if (c < chunks) buf[b] = load16(w + static_cast<size_t>(b % RPB) * K + c * V);
      }
      if (base == 0) load_input<T, PRO>(in, K, ln_w, ln_b, xin, red);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = base + (b / RPB) * kGemvThreads + tid;
        if (c < chunks) {
          float f[V];
          Vec16<WT>::unpack(buf[b], f);
          float a = acc[b % RPB];
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            const float4 x = *reinterpret_cast<const float4*>(xin + c * V + j);
            a = fmaf(f[j], x.x, fmaf(f[j + 1], x.y, fmaf(f[j + 2], x.z, fmaf(f[j + 3], x.w, a))));
          }
          acc[b % RPB] = a;
        }
      }
    }
  } else {
    load_input<T, PRO>(in, K, ln_w, ln_b, xin, red);
    for (int i = tid; i < K; i += kGemvThreads) {
#pragma unroll
      for (int r = 0; r < RPB; ++r)
        acc[r] = fmaf(to_f_any<WT>(w[static_cast<size_t>(r) * K + i]), xin[i], acc[r]);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < RPB; ++r) acc[r] = warp_sum(acc[r]);
  __syncthreads();  // `red` was the prologue's scratch
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RPB; ++r) red[warp * RPB + r] = acc[r];
  }
  __syncthreads();
  if (tid < RPB / 2) {  // one thread per row pair
    float a0 = 0.f, a1 = 0.f;
    for (int wi = 0; wi < kGemvWarps; ++wi) {
      a0 += red[wi * RPB + 2 * tid];
      a1 += red[wi * RPB + 2 * tid + 1];
    }
    if (ws != nullptr) {  // int8 rows: the product in T, then the row's scale
      a0 = round_t<T>(a0) * ws[r0 + 2 * tid];
      a1 = round_t<T>(a1) * ws[r0 + 2 * tid + 1];
    }
    epilogue<T, EPI>(out, r0 + 2 * tid, a0, a1, offset, D, Dh, rope_c);
  }
}

// One block per head: single-query attention of q over this layer's cache
// (slots valid iff 0 <= pos <= offset) plus the step's own k/v, then the
// append of the new k/v row at write_pos (each block owns its head's slice
// of the row and writes it after every read of the slice). A thread scores
// one slot at a time with 16-byte loads of its key; the value sum gives each
// thread one 16-byte column chunk of a strided subset of the slots.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attend_append_kernel(const T* __restrict__ qkv, T* __restrict__ cache_k,
                     T* __restrict__ cache_v, const int* __restrict__ pos,
                     const int* __restrict__ offset, int C, int H, int Dh, int write_pos,
                     float scale, int vec_ok, T* __restrict__ attn) {
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, D = H * Dh, tid = threadIdx.x;
  // value-sum layout: RPT threads per row (one per 16-byte chunk, or one per
  // element without vector loads), G slot groups
  const int RPT = vec_ok ? Dh / V : min(Dh, kThreads);
  const int G = kThreads / RPT;
  const int per = vec_ok ? V : (Dh + RPT - 1) / RPT;  // columns per thread
  float* q = smem;                  // [Dh]
  float* kn = q + Dh;               // [Dh]
  float* vn = kn + Dh;              // [Dh]
  float* w = vn + Dh;               // [C]: logits, then weights
  float* part = w + C;              // [G * RPT * per]
  float* red = part + G * RPT * per;  // [kWarps]
  int* ok = reinterpret_cast<int*>(red + kWarps);  // [C]: slot valid
  const size_t col = static_cast<size_t>(h) * Dh;
  const int off = *offset;
  for (int i = tid; i < Dh; i += kThreads) {
    q[i] = to_f<T>(qkv[col + i]);
    kn[i] = to_f<T>(qkv[D + col + i]);
    vn[i] = to_f<T>(qkv[2 * D + col + i]);
  }
  for (int c = tid; c < C; c += kThreads) {
    const int p = pos[c];
    ok[c] = p >= 0 && p <= off;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int c = tid; c < C; c += kThreads) {
    if (!ok[c]) continue;  // masked: never read
    const T* kr = cache_k + static_cast<size_t>(c) * D + col;
    float a = 0.f;
    if (vec_ok) {
#pragma unroll 8
      for (int i = 0; i < Dh; i += V) {
        float f[V];
        Vec16<T>::load(kr + i, f);
#pragma unroll
        for (int j = 0; j < V; ++j) a = fmaf(q[i + j], f[j], a);
      }
    } else {
      for (int i = 0; i < Dh; ++i) a = fmaf(q[i], to_f<T>(kr[i]), a);
    }
    w[c] = a * scale;
    m = fmaxf(m, w[c]);
  }
  float sn = 0.f;
  for (int i = 0; i < Dh; ++i) sn = fmaf(q[i], kn[i], sn);
  sn *= scale;
  m = block_max(fmaxf(m, sn), red);
  float s = 0.f;
  for (int c = tid; c < C; c += kThreads) {
    if (!ok[c]) continue;
    const float e = expf(w[c] - m);
    w[c] = e;
    s += e;
  }
  const float en = expf(sn - m);
  const float denom = block_sum(s, red) + en;
  for (int c = tid; c < C; c += kThreads)
    if (ok[c]) w[c] = round_t<T>(w[c] / denom);
  const float wn = round_t<T>(en / denom);
  __syncthreads();

  const int g = tid / RPT, r = tid % RPT;
  if (g < G) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    if (vec_ok) {
      for (int c = g; c < C; c += G) {
        if (!ok[c]) continue;
        float f[V];
        Vec16<T>::load(cache_v + static_cast<size_t>(c) * D + col + r * V, f);
        const float wc = w[c];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(wc, f[j], acc[j]);
      }
      for (int j = 0; j < V; ++j) part[g * Dh + r * V + j] = acc[j];
    } else {
      for (int d = r; d < Dh; d += RPT) {
        float a = 0.f;
        for (int c = g; c < C; c += G)
          if (ok[c]) a = fmaf(w[c], to_f<T>(cache_v[static_cast<size_t>(c) * D + col + d]), a);
        part[g * Dh + d] = a;
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < Dh; d += kThreads) {
    float a = 0.f;
    for (int gg = 0; gg < G; ++gg) a += part[gg * Dh + d];
    attn[col + d] = from_f<T>(a + wn * vn[d]);
    const size_t dst = static_cast<size_t>(write_pos) * D + col + d;
    cache_k[dst] = qkv[D + col + d];
    cache_v[dst] = qkv[2 * D + col + d];
  }
}

template <typename WT>
int vec_ok(const void* p, int K) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (K % Vec16<WT>::n == 0);
}

template <typename T, typename WT, int PRO, int EPI, int RPB>
cudaError_t gemv_rpb(const T* in, int K, const T* ln_w, const T* ln_b, const WT* W,
                     const float* ws, int rows, int vec, T* out, const int* offset, int D, int Dh,
                     float rope_c, cudaStream_t s) {
  const size_t bytes = (static_cast<size_t>(K) + kGemvWarps * RPB) * sizeof(float);
  cudaError_t e = allow_smem(gemv_kernel<T, WT, PRO, EPI, RPB>, bytes);
  if (e != cudaSuccess) return e;
  gemv_kernel<T, WT, PRO, EPI, RPB><<<rows / RPB, kGemvThreads, bytes, s>>>(
      in, K, ln_w, ln_b, W, ws, vec, out, offset, D, Dh, rope_c);
  return cudaGetLastError();
}

template <typename T, typename WT, int PRO, int EPI>
cudaError_t gemv(const T* in, int K, const T* ln_w, const T* ln_b, const WT* W,
                 const float* ws, int rows, T* out, const int* offset, int D, int Dh,
                 float rope_c, cudaStream_t s) {
  const int vec = vec_ok<WT>(W, K);
  if (vec && rows % 8 == 0 && K / Vec16<WT>::n <= kGemvThreads)
    return gemv_rpb<T, WT, PRO, EPI, 8>(in, K, ln_w, ln_b, W, ws, rows, vec, out, offset, D,
                                        Dh, rope_c, s);
  return gemv_rpb<T, WT, PRO, EPI, 2>(in, K, ln_w, ln_b, W, ws, rows, vec, out, offset, D, Dh,
                                      rope_c, s);
}

// Per-row scales of the four products, each [L, rows] f32; all null for
// plain weights.
struct Scales {
  const float *in_proj, *out_proj, *w1, *w2;
};

// Layer l's slice of a [L, rows] scale array (null stays null).
const float* layer_rows(const float* p, int l, int rows) {
  return p ? p + static_cast<size_t>(l) * rows : p;
}

template <typename T, typename WT>
cudaError_t run(int L, int D, int H, int F, int C, T* x, const WT* in_proj,
                const WT* out_proj, const WT* w1, const WT* w2, Scales sc, const T* n1s,
                const T* n1b, const T* n2s, const T* n2b, T* cache_k, T* cache_v,
                const int* pos, const int* offset, int write_pos, float max_period, T* scratch,
                cudaStream_t s) {
  const int Dh = D / H;
  const float rope_c = static_cast<float>(-log(static_cast<double>(max_period)) * 2.0 / Dh);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  T* qkv = scratch;        // [3D]
  T* attn = qkv + 3 * D;   // [D]
  T* g = attn + D;         // [F]
  constexpr int V = Vec16<T>::n;
  const int att_vec = Dh % V == 0 && Dh / V <= kThreads &&
                      reinterpret_cast<uintptr_t>(cache_k) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(cache_v) % 16 == 0;
  const int RPT = att_vec ? Dh / V : (Dh < kThreads ? Dh : kThreads);
  const int per = att_vec ? V : (Dh + RPT - 1) / RPT;
  const size_t att_bytes =
      (3 * static_cast<size_t>(Dh) + C + (kThreads / RPT) * RPT * per + kWarps + C) *
      sizeof(float);
  cudaError_t e = allow_smem(attend_append_kernel<T>, att_bytes);
  if (e != cudaSuccess) return e;
  for (int l = 0; l < L; ++l) {
    const size_t DD = static_cast<size_t>(D) * D, DF = static_cast<size_t>(D) * F;
    T* ck = cache_k + static_cast<size_t>(l) * C * D;
    T* cv = cache_v + static_cast<size_t>(l) * C * D;
    e = gemv<T, WT, kLayerNorm, kQkvRope>(x, D, n1s + l * D, n1b + l * D, in_proj + l * 3 * DD,
                                          layer_rows(sc.in_proj, l, 3 * D), 3 * D, qkv, offset,
                                          D, Dh, rope_c, s);
    if (e != cudaSuccess) return e;
    attend_append_kernel<T><<<H, kThreads, att_bytes, s>>>(qkv, ck, cv, pos, offset, C, H, Dh,
                                                          write_pos, scale, att_vec, attn);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = gemv<T, WT, kPlainIn, kResidual>(attn, D, nullptr, nullptr, out_proj + l * DD,
                                         layer_rows(sc.out_proj, l, D), D, x, offset, D, Dh,
                                         rope_c, s);
    if (e != cudaSuccess) return e;
    e = gemv<T, WT, kLayerNorm, kGelu>(x, D, n2s + l * D, n2b + l * D, w1 + l * DF,
                                       layer_rows(sc.w1, l, F), F, g, offset, D, Dh, rope_c, s);
    if (e != cudaSuccess) return e;
    e = gemv<T, WT, kPlainIn, kResidual>(g, F, nullptr, nullptr, w2 + l * DF,
                                         layer_rows(sc.w2, l, D), D, x, offset, D, Dh, rope_c, s);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

template <typename T>
int run_any(int quant, int L, int D, int H, int F, int C, void* x, const void* in_proj,
            const void* out_proj, const void* w1, const void* w2, Scales sc, const void* n1s,
            const void* n1b, const void* n2s, const void* n2b, void* cache_k, void* cache_v,
            const int* pos, const int* offset, int write_pos, float max_period, void* scratch,
            cudaStream_t s) {
  const T *a = static_cast<const T*>(n1s), *b = static_cast<const T*>(n1b);
  const T *c = static_cast<const T*>(n2s), *d = static_cast<const T*>(n2b);
  T *xx = static_cast<T*>(x), *ck = static_cast<T*>(cache_k), *cv = static_cast<T*>(cache_v);
  T* scr = static_cast<T*>(scratch);
  if (quant)
    return run<T, int8_t>(L, D, H, F, C, xx, static_cast<const int8_t*>(in_proj),
                          static_cast<const int8_t*>(out_proj), static_cast<const int8_t*>(w1),
                          static_cast<const int8_t*>(w2), sc, a, b, c, d, ck, cv, pos, offset,
                          write_pos, max_period, scr, s);
  return run<T, T>(L, D, H, F, C, xx, static_cast<const T*>(in_proj),
                   static_cast<const T*>(out_proj), static_cast<const T*>(w1),
                   static_cast<const T*>(w2), Scales{nullptr, nullptr, nullptr, nullptr}, a, b, c,
                   d, ck, cv, pos, offset, write_pos, max_period, scr, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (norms, cache, x and scratch, and the
// weights unless quant). quant: 1 = the four weights are int8 with f32
// per-row scales in_s [L,3D], out_s [L,D], w1_s [L,F], w2_s [L,D]
// (ignored otherwise). x [D] is the stack input on entry and its output on
// return. Weights are row-major per layer: in_proj [L,3D,D], out_proj
// [L,D,D], w1 [L,F,D], w2 [L,D,F]; norms [L,D]; caches [L,C,D]; pos [C] and
// offset [1] int32 on the device; scratch holds 4D + F elements. Returns
// cudaGetLastError().
extern "C" int decode_stack_run(int dtype, int quant, int L, int D, int H, int F, int C,
                                void* x, const void* in_proj, const void* out_proj,
                                const void* w1, const void* w2, const void* in_s,
                                const void* out_s, const void* w1_s, const void* w2_s,
                                const void* n1s, const void* n1b, const void* n2s,
                                const void* n2b, void* cache_k, void* cache_v, const void* pos,
                                const void* offset, int write_pos, float max_period,
                                void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* o = static_cast<const int*>(offset);
  const Scales sc{static_cast<const float*>(in_s), static_cast<const float*>(out_s),
                  static_cast<const float*>(w1_s), static_cast<const float*>(w2_s)};
  if (dtype == 0)
    return run_any<float>(quant, L, D, H, F, C, x, in_proj, out_proj, w1, w2, sc, n1s, n1b, n2s,
                          n2b, cache_k, cache_v, p, o, write_pos, max_period, scratch, s);
  return run_any<__nv_bfloat16>(quant, L, D, H, F, C, x, in_proj, out_proj, w1, w2, sc, n1s,
                                n1b, n2s, n2b, cache_k, cache_v, p, o, write_pos, max_period,
                                scratch, s);
}
