// Helpers shared by the port's CUDA kernels: dtype conversion, rounding to
// the working dtype, warp and block reductions, 16-byte vector loads (f32,
// bf16 and int8 rows), the bf16 tensor-core product and cp.async copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// The value an op's result takes once stored in the working dtype: the PyTorch
// and XLA versions round every op's output to it.
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions over NT threads; `red` is NT / 32 floats of shared
// memory. Every thread gets the result.
template <int NT = kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = lane < NT / 32 ? red[lane] : 0.f;
  t = warp_sum(t);
  return t;
}

template <int NT = kThreads>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = lane < NT / 32 ? red[lane] : -INFINITY;
  t = warp_max(t);
  return t;
}

// 16 bytes of a row: raw load (read-only path), then widened to f32.
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* o) { unpack(load16(p), o); }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    unpack(load16(p), o);
  }
};

// int8 weight rows (weight-only quantization): 16 values per 16 bytes.
template <> struct Vec16<int8_t> {
  static constexpr int n = 16;
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        o[4 * i + b] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
    }
  }
};

template <typename T> __device__ __forceinline__ float to_f_any(T v) { return to_f<T>(v); }
template <> __device__ __forceinline__ float to_f_any<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// ------------------------------------------------ tensor cores, async copies

// D += A . B on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col), f32
// sums. Lane (g = lane / 4, t = lane % 4): a0 (row g, k 2t, 2t + 1), a1 (row
// g + 8), a2 (row g, k 2t + 8, 2t + 9), a3 (row g + 8, k 2t + 8); b0 (k 2t,
// 2t + 1, col g), b1 (k 2t + 8, 2t + 9); d (row g, cols 2t, 2t + 1), then row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared, zeros when !ok; .cg bypasses L1, .ca keeps the
// line in L1 for the other warps of the SM.
template <bool L1>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  if (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raise the dynamic shared-memory limit of a kernel when a launch needs more
// than the default 48 KB.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pt
