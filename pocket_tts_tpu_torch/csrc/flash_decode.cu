// Single-query decode attention over the append-ordered KV cache, B >= 1.
//
// Replaces the Pallas kernel pocket_tts_tpu/ops/flash_decode.py
// (flash_decode_tpu / _kernel). For each row b and head h: the query
// q [B,H,Dh] attends the cache slots c < att whose position is valid,
// (pos[b,c] >= 0) & (pos[b,c] <= offset[b]), plus the step's own key/value
// (always valid). Softmax in f32 with scale 1/sqrt(Dh); output [B,H,Dh] in
// the cache dtype.
//
// Numerics follow the port's plain version (ops/flash_decode.py), which is
// the JAX package's flash_decode_ref and the production attend_cached: the
// softmax is normalised first and each weight rounded to the cache dtype
// before the value sum (f32), and the new term is round(w_new) * v_new in
// f32. The TPU kernel's online softmax divides at the end instead; in bf16
// that cannot give the same bits, so this kernel makes two passes.
//
// Bound on the H100: bytes, the valid k and v rows read once (B=32,
// att=256, D=1024 in bf16: 33.5 MB per layer, ~10 us at 3.35 TB/s). The
// design: one block per (b, h); pass 1 gives each slot a group of LPS lanes
// (one 16-byte chunk of the key's head slice per lane, reduced by shuffles)
// and keeps the scores in shared memory (at most 4096 f32 = 16 KB), then the
// block takes the max, the exponentials and their sum; pass 2 gives each
// group a strided subset of the slots, accumulates w * v for its lanes'
// chunks in f32 and the groups' partial sums meet in shared memory. Dead
// slots are skipped, never multiplied by zero, so a NaN there cannot leak.

#include <math.h>

#include "common.cuh"

namespace {

using namespace pt;

constexpr int kFdThreads = 128;
constexpr int kFdWarps = kFdThreads / 32;
constexpr int kMaxAtt = 4096;

// V values of a row, widened to f32: one 16-byte load when V fills it,
// element loads otherwise (the narrow path for head dims that do not divide
// into 16-byte chunks).
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* p, float* o) {
  if constexpr (V == Vec16<T>::n) {
    Vec16<T>::unpack(load16(p), o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = to_f<T>(p[j]);
  }
}

// CPL: chunks of V values per lane; a slot's group has `lps` lanes (a power
// of two <= 32 with lps * CPL * V >= Dh).
template <typename T, int V, int CPL>
__global__ void __launch_bounds__(kFdThreads)
flash_decode_kernel(const T* __restrict__ q, long long q_sb, const T* __restrict__ kn,
                    long long kn_sb, const T* __restrict__ vn, long long vn_sb,
                    const T* __restrict__ ck, const T* __restrict__ cv,
                    const int* __restrict__ pos, const int* __restrict__ offset, int C, int H,
                    int Dh, int att, int lps, float scale, T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int ng = kFdThreads / lps;
  float* qf = smem;                 // [Dh]
  float* w = qf + Dh;               // [att]: scores, then weights
  float* part = w + att;            // [ng * Dh]
  float* red = part + ng * Dh;      // [kFdWarps]
  unsigned char* ok = reinterpret_cast<unsigned char*>(red + kFdWarps);  // [att]
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int g = tid / lps, lis = tid % lps;
  const int chunks = Dh / V;
  const int off = offset[b];
  const T* qr = q + b * q_sb + static_cast<long long>(h) * Dh;
  const T* knr = kn + b * kn_sb + static_cast<long long>(h) * Dh;
  const T* vnr = vn + b * vn_sb + static_cast<long long>(h) * Dh;
  const size_t row = static_cast<size_t>(H) * Dh;  // one slot of the cache
  const T* kb = ck + static_cast<size_t>(b) * C * row + static_cast<size_t>(h) * Dh;
  const T* vb = cv + static_cast<size_t>(b) * C * row + static_cast<size_t>(h) * Dh;

  float sn = 0.f;
  for (int i = tid; i < Dh; i += kFdThreads) {
    qf[i] = to_f<T>(qr[i]);
    sn = fmaf(qf[i], to_f<T>(knr[i]), sn);
  }
  for (int c = tid; c < att; c += kFdThreads) {
    const int p = pos[static_cast<size_t>(b) * C + c];
    ok[c] = p >= 0 && p <= off;
  }
  sn = block_sum<kFdThreads>(sn, red) * scale;  // syncs: qf and ok are visible after it

  // pass 1: scores of the valid slots (every lane runs every round, so the
  // group's shuffles see all lanes)
  for (int base = 0; base < att; base += ng) {
    const int c = base + g;
    const bool valid = c < att && ok[c];
    float a = 0.f;
    if (valid) {
      const T* kr = kb + static_cast<size_t>(c) * row;
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        const int chunk = lis + ci * lps;
        if (chunk < chunks) {
          float f[V];
          load_vals<T, V>(kr + chunk * V, f);
#pragma unroll
          for (int j = 0; j < V; ++j) a = fmaf(qf[chunk * V + j], f[j], a);
        }
      }
    }
    for (int o = lps / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (valid && lis == 0) w[c] = a * scale;
  }
  __syncthreads();

  float m = sn;
  for (int c = tid; c < att; c += kFdThreads)
    if (ok[c]) m = fmaxf(m, w[c]);
  m = block_max<kFdThreads>(m, red);
  float s = 0.f;
  for (int c = tid; c < att; c += kFdThreads) {
    if (!ok[c]) continue;
    const float e = expf(w[c] - m);
    w[c] = e;
    s += e;
  }
  const float en = expf(sn - m);
  const float denom = block_sum<kFdThreads>(s, red) + en;
  for (int c = tid; c < att; c += kFdThreads)
    if (ok[c]) w[c] = round_t<T>(w[c] / denom);
  const float wn = round_t<T>(en / denom);
  __syncthreads();

  // pass 2: sum of w * v over this group's slots, per lane chunk
  float acc[CPL][V];
#pragma unroll
  for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[ci][j] = 0.f;
  for (int c = g; c < att; c += ng) {
    if (!ok[c]) continue;
    const T* vr = vb + static_cast<size_t>(c) * row;
    const float wc = w[c];
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci) {
      const int chunk = lis + ci * lps;
      if (chunk < chunks) {
        float f[V];
        load_vals<T, V>(vr + chunk * V, f);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[ci][j] = fmaf(wc, f[j], acc[ci][j]);
      }
    }
  }
#pragma unroll
  for (int ci = 0; ci < CPL; ++ci) {
    const int chunk = lis + ci * lps;
    if (chunk < chunks) {
#pragma unroll
      for (int j = 0; j < V; ++j) part[g * Dh + chunk * V + j] = acc[ci][j];
    }
  }
  __syncthreads();
  T* o = out + (static_cast<size_t>(b) * H + h) * Dh;
  for (int d = tid; d < Dh; d += kFdThreads) {
    float a = 0.f;
    for (int gg = 0; gg < ng; ++gg) a += part[gg * Dh + d];
    o[d] = from_f<T>(a + wn * to_f<T>(vnr[d]));
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <typename T, int V, int CPL>
cudaError_t launch(int B, int H, int Dh, int C, int att, const void* q, long long q_sb,
                   const void* kn, long long kn_sb, const void* vn, long long vn_sb,
                   const void* ck, const void* cv, const int* pos, const int* offset, float scale,
                   void* out, cudaStream_t st) {
  const int chunks = Dh / V;
  const int lps = pow2_at_least((chunks + CPL - 1) / CPL);
  if (lps > 32) return cudaErrorInvalidValue;
  const int ng = kFdThreads / lps;
  const size_t bytes = (static_cast<size_t>(Dh) + att + static_cast<size_t>(ng) * Dh + kFdWarps) *
                           sizeof(float) + att;
  cudaError_t e = allow_smem(flash_decode_kernel<T, V, CPL>, bytes);
  if (e != cudaSuccess) return e;
  flash_decode_kernel<T, V, CPL><<<B * H, kFdThreads, bytes, st>>>(
      static_cast<const T*>(q), q_sb, static_cast<const T*>(kn), kn_sb,
      static_cast<const T*>(vn), vn_sb, static_cast<const T*>(ck), static_cast<const T*>(cv), pos,
      offset, C, H, Dh, att, lps, scale, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int B, int H, int Dh, int C, int att, const void* q, long long q_sb,
                const void* kn, long long kn_sb, const void* vn, long long vn_sb, const void* ck,
                const void* cv, const int* pos, const int* offset, void* out, cudaStream_t st) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  constexpr int V = Vec16<T>::n;
  const bool vec = Dh % V == 0 && Dh / V <= 32 &&
                   reinterpret_cast<uintptr_t>(ck) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cv) % 16 == 0;
  if (vec)
    return launch<T, V, 1>(B, H, Dh, C, att, q, q_sb, kn, kn_sb, vn, vn_sb, ck, cv, pos, offset,
                           scale, out, st);
  return launch<T, 2, 2>(B, H, Dh, C, att, q, q_sb, kn, kn_sb, vn, vn_sb, ck, cv, pos, offset,
                         scale, out, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, caches and out alike).
// q/k_new/v_new: [B,H,Dh] with the given batch strides (elements), heads
// contiguous; caches [B,C,H,Dh] contiguous; pos [B,C] and offset [B] int32;
// out [B,H,Dh]. Even Dh <= 128, 0 <= att <= min(C, 4096). Returns
// cudaGetLastError(); cudaErrorInvalidValue for a case it does not take.
extern "C" int flash_decode_run(int dtype, int B, int H, int Dh, int C, int att, const void* q,
                                long long q_sb, const void* kn, long long kn_sb, const void* vn,
                                long long vn_sb, const void* ck, const void* cv, const void* pos,
                                const void* offset, void* out, void* stream) {
  if (Dh % 2 || Dh > 128 || att < 0 || att > C || att > kMaxAtt) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* o = static_cast<const int*>(offset);
  if (dtype == 0)
    return run<float>(B, H, Dh, C, att, q, q_sb, kn, kn_sb, vn, vn_sb, ck, cv, p, o, out, st);
  return run<__nv_bfloat16>(B, H, Dh, C, att, q, q_sb, kn, kn_sb, vn, vn_sb, ck, cv, p, o, out,
                            st);
}
