// Whole FlowLM layer stack for one T=1, B=1 decode step, with the KV append,
// as ONE persistent cooperative launch.
//
// Replaces the Pallas kernel pocket_tts_tpu/ops/decode_stack.py
// (decode_stack_tpu / _kernel). Per layer l, on the residual x [D]:
//   h = LN1(x); q,k,v = h @ in_proj[l].T, RoPE on q and k at position `offset`
//   x += Attn(q, cache[l] + the step's own k/v) @ out_proj[l].T
//   h = LN2(x); x += gelu(h @ w1[l].T) @ w2[l].T
// and the new k/v row is written into cache[l] at slot `write_pos`.
//
// Bound on the H100: bytes. At batch 1 every product is a matrix-vector
// product: every weight is read once per step (6 layers x 12.6 M params =
// 151 MB in bf16 at the flagship shape, 75 MB in int8) against ~25 MFLOP,
// so the step is a stream at the memory rate (3.35 TB/s: ~45 us in bf16).
// CUDA cores, not tensor cores: one activation row gives a tensor-core tile
// nothing to reuse.
//
// Design: one block per SM (the grid is the SM count x the blocks per SM
// that the shared memory allows), launched cooperatively so that every block
// is resident, with grid-wide barriers between the five phases of a layer:
//   1. LN1 + in_proj + RoPE -> qkv        2. attention
//   3. attention merge + KV append + out_proj + residual -> x
//   4. LN2 + w1 + GELU -> g               5. w2 + residual -> x
// Each block owns a fixed span of rows of each product (row_spans.cuh:
// contiguous, whole row pairs so RoPE pairs stay in one block, balanced by
// bytes over the whole step). The weights do not depend on the
// activations, so one producer warp walks the block's spans in step order
// (in_proj l, out_proj l, w1 l, w2 l, in_proj l+1, ...) and keeps a ring of
// 32 KB weight chunks in shared memory full with 1-D TMA copies
// (cp.async.bulk, completing on mbarriers, the weights marked evict-first in
// L2 so that the cache rows and activations stay). It never waits on a grid
// barrier:
// while the eight consumer warps sit at one, the ring (~190 KB per SM)
// fills with the next phase's rows. The consumers hold the phase's input
// vector in shared memory as f32, laid out so that a warp's reads are free
// of bank conflicts (`xslot4`), and each warp reduces its rows of a chunk
// on its own: no block barrier per chunk. The small ops are fused into the
// phase's prologue (LayerNorm, the attention merge) or the row-pair
// epilogue (RoPE, GELU, residual, int8 row scale).
//
// On the H100 the time goes to the chain of each layer's five barriers, the
// dependent loads after each and the attention, not to the weight stream:
// the producer finds the ring full for most of a step (PERF.md).
//
// Attention: each block of a head's S splits (S = write_pos / 128 rounded
// up, at most grid / H) finds its attended slots once per launch (slot c to
// split c % S, 0 <= pos[c] <= offset, compacted in slot order) and loads
// its first key and value rows before q. A split scores its slots; with
// S > 1 the head's blocks exchange their (max, sum of exp) at a head
// barrier and each forms the global max and denominator in one fixed order.
// The weights, normalised and rounded to the cache dtype, give an f32
// partial value sum; phase 3's prologue adds the S partials and the step's
// own term in a fixed order. So the rounding points are those of the plain
// version and the result does not depend on timing. The append of the
// step's k/v row happens in phase 3, after the grid barrier, so it never
// races a read of slot write_pos.
//
// Activations written by other blocks of the launch (x, qkv, g, the
// attention partials) are read with ld.global.cg, never through the
// non-coherent read-only path, so no block reads a stale L1 line.
//
// int8 rows (weight-only quantization, all four products or none): each
// row's f32 scale is applied in the epilogue at the port's matmul_t
// rounding points: the f32 sum rounded to the working dtype, times the
// scale, rounded again.
//
// Numerics follow the PyTorch plain version (ops/decode_stack.py), which
// follows the JAX package's XLA scan: f32 accumulation and statistics, every
// op's result rounded to the working dtype, softmax in f32 with its weights
// rounded to the cache dtype before the value sum, exact-erf GELU.
// Masked cache slots are skipped, never multiplied by zero, so a NaN in a
// dead slot cannot leak. Sums are taken in a fixed order: a replay gives the
// same bits.
//
// The barrier words and the attention partials are the module's own device
// memory (one set per device, zero at load): nothing is allocated per launch,
// and the first launch may already be a graph capture. The barrier words
// return to their start state's low bits after every barrier, so they are
// ready for the next launch and a CUDA-graph replay; launches on one device
// must not run concurrently. The host side keeps the launch plan (grid,
// shared-memory limit) per device and shape.

#include <math.h>

#include <mutex>
#include <vector>

#include "common.cuh"
#include "row_spans.cuh"

namespace {

using namespace pt;

constexpr int kConsumers = 256;  // eight consumer warps
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBlockThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 16;
constexpr int kMinStageBytes = 32768;
constexpr int kWordStride = 32;  // barrier words 128 bytes apart
constexpr int kMaxHeads = 64;
constexpr int kSlotsPerSplit = 128;  // filled cache slots per attention split
constexpr int kMaxBlocks = 1024;     // the largest grid the partials below hold
constexpr int kMaxHeadDim = 256;     // a head of at most 512 bytes, in bf16

// The grid barrier's word, then one per head (kWordStride apart).
__device__ unsigned g_bar[kWordStride * (1 + kMaxHeads)];
// Attention partials of the H * S splits (H * S <= grid): value sums
// [H, S, Dh], then (max, sum of exp) [H, S, 2], then the step's own weight [H].
__device__ __align__(16) float g_part[kMaxBlocks * (kMaxHeadDim + 2) + kMaxHeads];

enum Epilogue { kQkvRope = 0, kResidual = 1, kGelu = 2 };

struct Params {
  int L, D, H, F, C, S, write_pos;
  float rope_c, scale;
  int stage_bytes, n_stages, xin_floats, vidx_ints;
  void* x;                // [D] residual stream, in and out
  const void* w[4];       // in_proj [L,3D,D], out_proj [L,D,D], w1 [L,F,D], w2 [L,D,F]
  const float* ws[4];     // int8 row scales [L, rows] (null for float weights)
  const void *n1s, *n1b, *n2s, *n2b;  // [L, D]
  void *cache_k, *cache_v;            // [L, C, D]
  const int* pos;                     // [C]
  const int* offset;                  // [1]
  void* qkv;                          // [3D] scratch
  void* g;                            // [F] scratch
};

// Where split s of head h keeps its partial value sum [Dh] and its (max, sum
// of exp), and head h the step's own normalised weight, in g_part.
__device__ __forceinline__ float* part_sum(const Params& p, int h, int s) {
  return g_part + (static_cast<size_t>(h) * p.S + s) * (p.D / p.H);
}
__device__ __forceinline__ float* part_stats(const Params& p, int h) {
  return g_part + static_cast<size_t>(p.H) * p.S * (p.D / p.H) + static_cast<size_t>(h) * p.S * 2;
}
__device__ __forceinline__ float* part_new(const Params& p) {
  return g_part + static_cast<size_t>(p.H) * p.S * (p.D / p.H + 2);
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// A wait that outlasts this many cycles (~10 s) is a fault: trap, so the
// launch fails with an error instead of hanging the card.
constexpr long long kSpinLimit = 20000000000LL;

__device__ __forceinline__ void watchdog(long long t0) {
  if (clock64() - t0 > kSpinLimit) __trap();
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    watchdog(t0);
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// 1-D TMA: `bytes` (a multiple of 16) from global to shared memory, counted
// on the mbarrier as they land. The weights are read once per step and
// outnumber the L2, so they go in evict-first: the cache rows and the
// activations stay.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* b, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// Barrier of the consumer warps only (the producer never joins it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier of n blocks (their consumers) on one word, as cooperative
// groups' grid sync keeps it: the master adds 2^31 - (n - 1), the others 1,
// so the top bit flips when the last arrives and the low bits return to
// zero: the word is ready for the next barrier, launch or graph replay.
// Thread 0 arrives with a release reduction and polls with acquire loads
// until the top bit leaves `epoch`, which the block read from the word
// before its first arrival: the word cannot flip without this block, so it
// flips once per barrier. The block barriers around it order the other
// threads' accesses. (Arrivals spread over 8 words were no faster on the
// H100: PERF.md.)
__device__ void sync_blocks(unsigned* word, unsigned n, bool master, unsigned& epoch) {
  consumer_sync();
  if (threadIdx.x == 0) {
    const unsigned add = master ? 0x80000000u - (n - 1) : 1u;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(word), "r"(add) : "memory");
    const long long t0 = clock64();
    while ((ld_acquire(word) >> 31) == epoch) watchdog(t0);
    epoch ^= 1u;
  }
  consumer_sync();
}

// Coherent (L2) loads and stores of values written within the launch.
template <typename T> __device__ __forceinline__ float ld_cg(const T* p);
template <> __device__ __forceinline__ float ld_cg<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ float ld_cg<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
template <typename T> __device__ __forceinline__ void st_cg(T* p, float v);
template <> __device__ __forceinline__ void st_cg<float>(float* p, float v) { __stcg(p, v); }
template <> __device__ __forceinline__ void st_cg<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16(v)));
}
__device__ __forceinline__ uint4 ld_cg16(const void* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

// A 16-byte vector of weights widened to f32 from registers (no address
// taken, so the ring read stays one 16-byte shared load). int8 goes through
// 2^23 + (b + 128) built by a byte permute: exact, and full rate.
template <typename WT> struct Wvec;
template <> struct Wvec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Wvec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Wvec<int8_t> {
  static constexpr int n = 16;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                           u.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + b)) - 8388736.f;
    }
  }
};

// The input vector in shared memory, laid out for the weight vectors that
// multiply it: weight vector c of a row covers elements c*V .. c*V + V - 1,
// and its j-th group of four sits in plane j at float4 c. The lanes of a
// warp (consecutive c) then read consecutive float4s: no bank conflicts.
// Returns the float4 slot of elements i .. i + 3 (i a multiple of 4).
template <int V>
__device__ __forceinline__ int xslot4(int i, int K) {
  return ((i % V) / 4) * (K / V) + i / V;
}

// Reductions over the consumer threads; `red` is kConsumerWarps floats.
__device__ __forceinline__ float consumer_sum(float v, float* red) {
  v = warp_sum(v);
  consumer_sync();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  consumer_sync();
  return warp_sum(threadIdx.x % 32 < kConsumerWarps ? red[threadIdx.x % 32] : 0.f);
}
// Two sums at once; `red` is 2 * kConsumerWarps floats.
__device__ __forceinline__ void consumer_sum2(float& a, float& b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  consumer_sync();
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32] = a;
    red[kConsumerWarps + threadIdx.x / 32] = b;
  }
  consumer_sync();
  const int lane = threadIdx.x % 32;
  a = warp_sum(lane < kConsumerWarps ? red[lane] : 0.f);
  b = warp_sum(lane < kConsumerWarps ? red[kConsumerWarps + lane] : 0.f);
}
__device__ __forceinline__ float consumer_max(float v, float* red) {
  v = warp_max(v);
  consumer_sync();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  consumer_sync();
  return warp_max(threadIdx.x % 32 < kConsumerWarps ? red[threadIdx.x % 32] : -INFINITY);
}

// Rows of one product a ring chunk holds: whole row pairs, at most one row
// per consumer thread. Producer and consumers walk the same chunks.
__host__ __device__ __forceinline__ int chunk_rows(int row_bytes, int stage_bytes) {
  const int r = stage_bytes / row_bytes;
  return (r < kConsumers ? r : kConsumers) & ~1;
}

// Consumer threads per row of a chunk: a power of two, rows * tpr <= kConsumers.
__host__ __device__ __forceinline__ int threads_per_row(int rpc) {
  int tpr = 1;
  while (tpr * 2 * rpc <= kConsumers) tpr *= 2;
  return tpr;
}

__host__ __device__ __forceinline__ int product_rows(int q, int D, int F) {
  return q == 0 ? 3 * D : (q == 2 ? F : D);
}
__host__ __device__ __forceinline__ int product_k(int q, int D, int F) {
  return q == 3 ? F : D;
}

// ------------------------------------------------------------ the producer

template <typename WT>
__device__ void produce(const Params& p, const int* lo, const int* hi, unsigned char* ring,
                        uint64_t* full, uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  const uint64_t policy = evict_first_policy();
  for (int l = 0; l < p.L; ++l) {
    for (int q = 0; q < 4; ++q) {
      const int K = product_k(q, p.D, p.F), rows = product_rows(q, p.D, p.F);
      const int row_bytes = K * static_cast<int>(sizeof(WT));
      const int rpc = chunk_rows(row_bytes, p.stage_bytes);
      const unsigned char* base = static_cast<const unsigned char*>(p.w[q]) +
                                  static_cast<size_t>(l) * rows * row_bytes;
      for (int r = lo[q]; r < hi[q]; r += rpc) {
        const int n = min(rpc, hi[q] - r);
        mbar_wait(&empty[stage], phase ^ 1u);
        const uint32_t bytes = static_cast<uint32_t>(n * row_bytes);
        mbar_expect_tx(&full[stage], bytes);
        bulk_load(ring + static_cast<size_t>(stage) * p.stage_bytes,
                  base + static_cast<size_t>(r) * row_bytes, bytes, &full[stage], policy);
        if (++stage == p.n_stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  }
}

// ------------------------------------------------------------ the consumers

// Ring position shared by a block's consumer threads (each keeps a copy).
struct Ring {
  unsigned char* base;
  uint64_t *full, *empty;
  float* part;  // [part_floats] row partials of the block's span
  int stage;
  uint32_t phase;
};

// Rows [lo, hi) of product q of layer l against xin (f32 [K] in shared
// memory). Each warp walks the ring chunks on its own (no block barrier per
// chunk) and leaves its rows' partial sums in shared memory; one barrier,
// then the epilogue per row pair, its inputs fetched before the chunks.
template <typename T, typename WT, int EPI>
__device__ void consume(const Params& p, int q, int l, int lo, int hi, const float* xin,
                        Ring& ring, T* out) {
  constexpr int V = Wvec<WT>::n;
  const int K = product_k(q, p.D, p.F), rows = product_rows(q, p.D, p.F);
  const int row_bytes = K * static_cast<int>(sizeof(WT));
  const int rpc = chunk_rows(row_bytes, p.stage_bytes);
  const int tpr = threads_per_row(rpc);
  const int vr = row_bytes / 16;  // 16-byte vectors per row
  const int plane = K / V;        // float4s per plane of xin
  const float4* xin4 = reinterpret_cast<const float4*>(xin);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = tid / tpr, sub = tid % tpr;
  const int wpr = tpr >= 32 ? tpr / 32 : 1;  // warps per row
  const int wslot = tpr >= 32 ? warp % wpr : 0;
  const float* scales = p.ws[q] ? p.ws[q] + static_cast<size_t>(l) * rows : nullptr;
  // the epilogue's inputs of pair tid, fetched while the sums are formed
  const int rr = lo + 2 * tid;
  float e0 = 0.f, e1 = 0.f, s0 = 1.f, s1 = 1.f, rc = 1.f, rs = 0.f;
  if (rr < hi) {
    if (EPI == kResidual) {
      e0 = ld_cg(out + rr);
      e1 = ld_cg(out + rr + 1);
    }
    if (scales) {
      s0 = __ldg(scales + rr);
      s1 = __ldg(scales + rr + 1);
    }
    if (EPI == kQkvRope && rr < 2 * p.D) {
      const int j = (rr % (p.D / p.H)) / 2;
      const float ang = static_cast<float>(*p.offset) * expf(static_cast<float>(j) * p.rope_c);
      rc = cosf(ang);
      rs = sinf(ang);
    }
  }
  for (int r0 = lo; r0 < hi; r0 += rpc) {
    const int n = min(rpc, hi - r0);
    mbar_wait(&ring.full[ring.stage], ring.phase);
    float a[2] = {0.f, 0.f};  // two independent chains
    if (row < n) {
      const uint4* wrow = reinterpret_cast<const uint4*>(
          ring.base + static_cast<size_t>(ring.stage) * p.stage_bytes + row * row_bytes);
      int c = sub;
      for (; c + tpr < vr; c += 2 * tpr) {
        uint4 u[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) u[k] = wrow[c + k * tpr];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float f[V];
          Wvec<WT>::unpack(u[k], f);
#pragma unroll
          for (int j = 0; j < V / 4; ++j) {
            const float4 xx = xin4[j * plane + c + k * tpr];
            a[k] = fmaf(f[4 * j], xx.x, fmaf(f[4 * j + 1], xx.y,
                        fmaf(f[4 * j + 2], xx.z, fmaf(f[4 * j + 3], xx.w, a[k]))));
          }
        }
      }
      for (; c < vr; c += tpr) {
        float f[V];
        Wvec<WT>::unpack(wrow[c], f);
#pragma unroll
        for (int j = 0; j < V / 4; ++j) {
          const float4 xx = xin4[j * plane + c];
          a[0] = fmaf(f[4 * j], xx.x, fmaf(f[4 * j + 1], xx.y,
                      fmaf(f[4 * j + 2], xx.z, fmaf(f[4 * j + 3], xx.w, a[0]))));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[ring.stage]);  // the warp is done with the chunk
    float acc = a[0] + a[1];
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      if (o < tpr) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (tpr >= 32) {
      if (lane == 0 && row < n) ring.part[(r0 - lo + row) * wpr + wslot] = acc;
    } else if (sub == 0 && row < n) {
      ring.part[r0 - lo + row] = acc;
    }
    if (++ring.stage == p.n_stages) {
      ring.stage = 0;
      ring.phase ^= 1u;
    }
  }
  consumer_sync();
  for (int pp = tid; 2 * pp < hi - lo; pp += kConsumers) {
    const int r = lo + 2 * pp;
    if (pp != tid) {  // beyond the first pair per thread: fetch now
      if (EPI == kResidual) {
        e0 = ld_cg(out + r);
        e1 = ld_cg(out + r + 1);
      }
      if (scales) {
        s0 = __ldg(scales + r);
        s1 = __ldg(scales + r + 1);
      }
      if (EPI == kQkvRope) {
        rc = 1.f;
        rs = 0.f;
        if (r < 2 * p.D) {
          const int j = (r % (p.D / p.H)) / 2;
          const float ang = static_cast<float>(*p.offset) * expf(static_cast<float>(j) * p.rope_c);
          rc = cosf(ang);
          rs = sinf(ang);
        }
      }
    }
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < wpr; ++j) {  // fixed order
      a0 += ring.part[2 * pp * wpr + j];
      a1 += ring.part[(2 * pp + 1) * wpr + j];
    }
    if (scales) {  // int8 rows: the product in T, then the row's scale
      a0 = round_t<T>(a0) * s0;
      a1 = round_t<T>(a1) * s1;
    }
    const float y0 = round_t<T>(a0), y1 = round_t<T>(a1);
    if (EPI == kQkvRope) {
      st_cg(out + r, y0 * rc - y1 * rs);
      st_cg(out + r + 1, y0 * rs + y1 * rc);
    } else if (EPI == kResidual) {
      st_cg(out + r, e0 + y0);
      st_cg(out + r + 1, e1 + y1);
    } else {
      const float k = 0.70710678118654752f;
      st_cg(out + r, 0.5f * y0 * (1.f + erff(y0 * k)));
      st_cg(out + r + 1, 0.5f * y1 * (1.f + erff(y1 * k)));
    }
  }
}

// dst = f32 of v [n] (written within the launch) in natural order, n a
// multiple of Wvec<T>::n.
template <typename T>
__device__ __forceinline__ void load_vector(const T* v, int n, float* dst) {
  constexpr int V = Wvec<T>::n;
  for (int c = threadIdx.x; c < n / V; c += kConsumers) {
    float f[V];
    Wvec<T>::unpack(ld_cg16(v + c * V), f);
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(dst + c * V + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
}

// xin = f32 of v [n] in the planes of weight vectors of VW elements.
template <typename T, int VW>
__device__ __forceinline__ void load_planes(const T* v, int n, float* xin) {
  constexpr int V = Wvec<T>::n;
  float4* xin4 = reinterpret_cast<float4*>(xin);
  for (int c = threadIdx.x; c < n / V; c += kConsumers) {
    float f[V];
    Wvec<T>::unpack(ld_cg16(v + c * V), f);
#pragma unroll
    for (int j = 0; j < V; j += 4)
      xin4[xslot4<VW>(c * V + j, n)] = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
}

// xin = LN(x) rounded to T (f32 statistics, eps 1e-5), in the planes of
// weight vectors of VW elements; xin[D, 2D) holds x meanwhile.
template <typename T, int VW>
__device__ void layer_norm_in(const T* x, int D, const T* w, const T* b, float* xin,
                              float* red) {
  float* raw = xin + D;
  load_vector(x, D, raw);
  consumer_sync();
  // f32 statistics in one pass, about a shift (x[0]) so that they do not
  // cancel: mean = k + sum(d) / D, var = (sum(d^2) - sum(d)^2 / D) / D
  const float k = raw[0];
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += kConsumers) {
    const float d = raw[i] - k;
    s1 += d;
    s2 = fmaf(d, d, s2);
  }
  consumer_sum2(s1, s2, red);
  const float inv_d = 1.f / static_cast<float>(D);
  const float mean = k + s1 * inv_d;
  const float r = rsqrtf(fmaxf(s2 - s1 * s1 * inv_d, 0.f) * inv_d + 1e-5f);
  float4* xin4 = reinterpret_cast<float4*>(xin);
  for (int i = 4 * threadIdx.x; i < D; i += 4 * kConsumers) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = round_t<T>((raw[i + e] - mean) * r * to_f<T>(w[i + e]) + to_f<T>(b[i + e]));
    xin4[xslot4<VW>(i, D)] = make_float4(o[0], o[1], o[2], o[3]);
  }
  consumer_sync();
}

// Phase 2 for unit (h, s): head h over its n_v attended slots vidx[0..n_v)
// (split s of S). Scores and the split's (max, sum of exp); with S > 1 the
// head's S blocks exchange them at a head barrier; then the weights under
// the head's global max and denominator and the f32 partial value sum.
template <typename T>
__device__ void attend_split(const Params& p, int l, int h, int s, const int* vidx, int n_v,
                             float* smem, float* red, unsigned& head_epoch) {
  constexpr int V = Wvec<T>::n;
  const int D = p.D, Dh = D / p.H, S = p.S, tid = threadIdx.x, lane = tid % 32;
  const int vrow = Dh / V;  // 16-byte vectors of a head's row (at most 32)
  int lps = 1;              // lanes per slot in the scores (a power of two)
  while (lps < vrow) lps *= 2;
  float* q = smem;        // [Dh]
  float* kn = q + Dh;     // [Dh]
  float* st = kn + Dh;    // [2S]
  float* w = st + 2 * S;  // [n_v]: scores, then weights
  float* vp = w + ((p.vidx_ints + 3) & ~3);  // [groups * Dh]
  const T* qkv = static_cast<const T*>(p.qkv);
  const size_t col = static_cast<size_t>(h) * Dh;
  const T* ck = static_cast<const T*>(p.cache_k) + static_cast<size_t>(l) * p.C * D + col;
  const T* cv = static_cast<const T*>(p.cache_v) + static_cast<size_t>(l) * p.C * D + col;
  // The cache rows do not depend on q: the first batch of key rows (score
  // layout) and of value rows (value-sum layout) is loaded before q, so the
  // three round trips overlap.
  constexpr int kBatch = 4;
  const int per_pass = kConsumers / lps, gi = tid / lps, li = tid % lps;
  const int groups = kConsumers / vrow;  // value sum: slot groups of vrow threads
  const int g = tid / vrow, r = tid % vrow;
  uint4 k0[kBatch], v0[kBatch];
#pragma unroll
  for (int t = 0; t < kBatch; ++t) {
    const int i = t * per_pass + gi;
    if (i < n_v && li < vrow)
      k0[t] = __ldg(reinterpret_cast<const uint4*>(ck + static_cast<size_t>(vidx[i]) * D + li * V));
    const int j = g + t * groups;
    if (g < groups && j < n_v)
      v0[t] = __ldg(reinterpret_cast<const uint4*>(cv + static_cast<size_t>(vidx[j]) * D + r * V));
  }
  for (int i = tid; i < Dh; i += kConsumers) {
    q[i] = ld_cg(qkv + col + i);
    kn[i] = ld_cg(qkv + D + col + i);
  }
  consumer_sync();
  // scores, kBatch passes of kConsumers / lps slots at a time, their loads
  // issued first; each lane holds at most one 16-byte vector of a row
  float m = -INFINITY;
  for (int ib = 0; ib < n_v; ib += per_pass * kBatch) {  // warp-uniform trip count
    uint4 u[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int i = ib + t * per_pass + gi;
      if (ib == 0)
        u[t] = k0[t];
      else if (i < n_v && li < vrow)
        u[t] = __ldg(reinterpret_cast<const uint4*>(ck + static_cast<size_t>(vidx[i]) * D +
                                                    li * V));
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int i = ib + t * per_pass + gi;
      float a = 0.f;
      if (i < n_v && li < vrow) {
        float f[V];
        Wvec<T>::unpack(u[t], f);
#pragma unroll
        for (int e = 0; e < V; ++e) a = fmaf(q[li * V + e], f[e], a);
      }
      for (int o = lps / 2; o > 0; o /= 2) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (i < n_v && li == 0) {
        w[i] = a * p.scale;
        m = fmaxf(m, w[i]);
      }
    }
  }
  // the step's own key, scored the same way (the same bits) by every split
  float sn = 0.f;
  for (int i = lane; i < Dh; i += 32) sn = fmaf(q[i], kn[i], sn);
  sn = warp_sum(sn) * p.scale;
  m = consumer_max(m, red);
  float e = 0.f;
  for (int i = tid; i < n_v; i += kConsumers) e += expf(w[i] - m);
  const float lsum = consumer_sum(e, red);
  if (S > 1) {
    float* stats = part_stats(p, h);
    if (tid == 0) {
      __stcg(stats + 2 * s, m);
      __stcg(stats + 2 * s + 1, lsum);
    }
    sync_blocks(g_bar + kWordStride * (1 + h), S, s == 0, head_epoch);
    for (int i = tid; i < 2 * S; i += kConsumers) st[i] = __ldcg(stats + i);
  } else if (tid == 0) {
    st[0] = m;
    st[1] = lsum;
  }
  consumer_sync();
  float M = sn;
  for (int j = 0; j < S; ++j) M = fmaxf(M, st[2 * j]);
  float denom = 0.f;
  for (int j = 0; j < S; ++j)
    if (st[2 * j + 1] > 0.f) denom += st[2 * j + 1] * expf(st[2 * j] - M);
  denom += expf(sn - M);
  for (int i = tid; i < n_v; i += kConsumers) w[i] = round_t<T>(expf(w[i] - M) / denom);
  if (s == 0 && tid == 0) __stcg(part_new(p) + h, round_t<T>(expf(sn - M) / denom));
  consumer_sync();
  // value sum: vrow threads per slot row (one 16-byte column chunk each),
  // `groups` slot groups, kBatch slots of a group loaded at a time
  if (g < groups) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int i0 = g; i0 < n_v; i0 += groups * kBatch) {
      uint4 u[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int i = i0 + t * groups;
        if (i0 == g)
          u[t] = v0[t];
        else if (i < n_v)
          u[t] = __ldg(reinterpret_cast<const uint4*>(cv + static_cast<size_t>(vidx[i]) * D +
                                                      r * V));
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int i = i0 + t * groups;
        if (i >= n_v) continue;
        float f[V];
        Wvec<T>::unpack(u[t], f);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(w[i], f[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) vp[g * Dh + r * V + j] = acc[j];
  }
  consumer_sync();
  // the groups' sums, each column by kConsumers / Dh threads, in a fixed order
  const int parts = kConsumers / Dh, per = (groups + parts - 1) / parts;
  float* vq = vp + groups * Dh;  // [parts * Dh]
  if (tid < parts * Dh) {
    const int pq = tid / Dh, d = tid % Dh;
    float a = 0.f;
    for (int gg = pq * per; gg < min(groups, (pq + 1) * per); ++gg) a += vp[gg * Dh + d];
    vq[pq * Dh + d] = a;
  }
  consumer_sync();
  float* out = part_sum(p, h, s);
  for (int d = tid; d < Dh; d += kConsumers) {
    float a = 0.f;
    for (int pq = 0; pq < parts; ++pq) a += vq[pq * Dh + d];
    __stcg(out + d, a);
  }
}

// The slots c = s, s + S, ... (c < C) attended by split s (0 <= pos[c] <=
// offset), in slot order, into vidx; returns their count. Once per launch:
// the positions and the offset do not change within it.
__device__ int attended_slots(const Params& p, int s, int* vidx, int* warp_counts) {
  const int off = *p.offset, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_s = s < p.C ? (p.C - s + p.S - 1) / p.S : 0;
  int base = 0;
  for (int i0 = 0; i0 < n_s; i0 += kConsumers) {
    const int i = i0 + tid, c = s + i * p.S;
    bool ok = false;
    if (i < n_s) {
      const int pc = p.pos[c];
      ok = pc >= 0 && pc <= off;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    consumer_sync();
    int before = base, total = base;
    for (int w = 0; w < kConsumerWarps; ++w) {
      if (w < warp) before += warp_counts[w];
      total += warp_counts[w];
    }
    if (ok) vidx[before + __popc(ballot & ((1u << lane) - 1u))] = c;
    base = total;
    consumer_sync();
  }
  return base;
}

// Phase 3's prologue: attn = the S partial value sums of each head plus the
// step's own term, rounded to T, into xin; and the KV append of layer l.
template <typename T, int VW>
__device__ void merge_and_append(const Params& p, int l, float* xin) {
  const int D = p.D, Dh = D / p.H, S = p.S, tid = threadIdx.x;
  const T* qkv = static_cast<const T*>(p.qkv);
  for (int d4 = tid; d4 < D / 4; d4 += kConsumers) {
    const int d = 4 * d4, h = d / Dh, dd = d % Dh;
    const float4* src = reinterpret_cast<const float4*>(part_sum(p, h, 0) + dd);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {  // fixed order
      const float4 v = __ldcg(src + s * (Dh / 4));
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    const float wn = __ldcg(part_new(p) + h);
    reinterpret_cast<float4*>(xin)[xslot4<VW>(d, D)] =
        make_float4(round_t<T>(a.x + wn * ld_cg(qkv + 2 * D + d)),
                    round_t<T>(a.y + wn * ld_cg(qkv + 2 * D + d + 1)),
                    round_t<T>(a.z + wn * ld_cg(qkv + 2 * D + d + 2)),
                    round_t<T>(a.w + wn * ld_cg(qkv + 2 * D + d + 3)));
  }
  // every read of layer l's cache is done (grid barrier): append k|v
  const size_t row = (static_cast<size_t>(l) * p.C + p.write_pos) * D;
  for (int i = blockIdx.x * kConsumers + tid; i < 2 * D; i += gridDim.x * kConsumers) {
    T* dst = static_cast<T*>(i < D ? p.cache_k : p.cache_v) + row + (i % D);
    st_cg(dst, ld_cg(qkv + D + i));
  }
  consumer_sync();
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kBlockThreads, 1) stack_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(p.n_stages) * p.stage_bytes);
  uint64_t* empty = full + kMaxStages;
  float* xin = reinterpret_cast<float*>(empty + kMaxStages);
  float* red = xin + p.xin_floats;  // [32]
  int* vidx = reinterpret_cast<int*>(red + 32);  // [vidx_ints]: this block's attended slots
  float* part = red + 32 + p.vidx_ints;          // [part_floats]
  int lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo[q] = span_start(q, b, G, p.D, p.F);
    hi[q] = span_start(q, b + 1, G, p.D, p.F);
  }
  if (tid == 0) {
    for (int i = 0; i < p.n_stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumers) {
    if (tid == kConsumers) produce<WT>(p, lo, hi, ring, full, empty);
    return;
  }
  const bool attends = b < p.H * p.S;
  const int h_of = b / p.S, s_of = b % p.S;
  // the epoch bits of the block's barrier words, before its first arrival
  unsigned grid_epoch = 0, head_epoch = 0;
  if (tid == 0) {
    grid_epoch = ld_acquire(g_bar) >> 31;
    if (attends) head_epoch = ld_acquire(g_bar + kWordStride * (1 + h_of)) >> 31;
  }
  const int n_v = attends ? attended_slots(p, s_of, vidx, reinterpret_cast<int*>(red)) : 0;
  Ring rg{ring, full, empty, part, 0, 0u};
  T* x = static_cast<T*>(p.x);
  T* qkv = static_cast<T*>(p.qkv);
  T* g = static_cast<T*>(p.g);
  const T *n1s = static_cast<const T*>(p.n1s), *n1b = static_cast<const T*>(p.n1b);
  const T *n2s = static_cast<const T*>(p.n2s), *n2b = static_cast<const T*>(p.n2b);
  const int D = p.D;
  constexpr int VW = Wvec<WT>::n;
  for (int l = 0; l < p.L; ++l) {
    const size_t ln = static_cast<size_t>(l) * D;
    layer_norm_in<T, VW>(x, D, n1s + ln, n1b + ln, xin, red);
    consume<T, WT, kQkvRope>(p, 0, l, lo[0], hi[0], xin, rg, qkv);
    sync_blocks(g_bar, G, b == 0, grid_epoch);
    if (attends) attend_split<T>(p, l, h_of, s_of, vidx, n_v, xin, red, head_epoch);
    sync_blocks(g_bar, G, b == 0, grid_epoch);
    merge_and_append<T, VW>(p, l, xin);
    consume<T, WT, kResidual>(p, 1, l, lo[1], hi[1], xin, rg, x);
    sync_blocks(g_bar, G, b == 0, grid_epoch);
    layer_norm_in<T, VW>(x, D, n2s + ln, n2b + ln, xin, red);
    consume<T, WT, kGelu>(p, 2, l, lo[2], hi[2], xin, rg, g);
    sync_blocks(g_bar, G, b == 0, grid_epoch);
    load_planes<T, VW>(g, p.F, xin);
    consumer_sync();
    consume<T, WT, kResidual>(p, 3, l, lo[3], hi[3], xin, rg, x);
    if (l + 1 < p.L) sync_blocks(g_bar, G, b == 0, grid_epoch);
  }
}

// ------------------------------------------------------------ host side

struct Layout {
  int stage_bytes, n_stages, xin_floats, vidx_ints;
  size_t smem;
};

// Shared memory of one block of a `grid`-block launch with S attention
// splits per head, within `optin` bytes: the weight ring (as many stages as
// fit), its mbarriers, the input vector (or the attention scratch),
// reduction space, the split's attended slots and the span's row partials
// (span_start gives a block at most ceil(pairs / grid) pairs).
cudaError_t layout(int optin, int es_t, int es_w, int D, int H, int F, int C, int grid, int S,
                   Layout* out) {
  const int Dh = D / H, V = 16 / es_t;
  int stage = 2 * (D > F ? D : F) * es_w;  // a chunk holds a row pair of every product
  if (stage < kMinStageBytes) stage = kMinStageBytes;
  stage = (stage + 127) & ~127;
  const int n_s = (C + S - 1) / S;
  int xin = 2 * Dh + 2 * S + ((n_s + 3) & ~3) + kConsumers * V + kConsumers;  // attention
  if (xin < F) xin = F;
  if (xin < 2 * D) xin = 2 * D;  // LayerNorm keeps x beside its output
  xin = (xin + 3) & ~3;
  int part = 0;
  for (int q = 0; q < 4; ++q) {
    const int pairs = product_rows(q, D, F) / 2;
    const int tpr = threads_per_row(chunk_rows(product_k(q, D, F) * es_w, stage));
    const int n = 2 * ((pairs + grid - 1) / grid) * (tpr >= 32 ? tpr / 32 : 1);
    if (n > part) part = n;
  }
  const size_t fixed = 2 * kMaxStages * sizeof(uint64_t) +
                       (static_cast<size_t>(xin) + 32 + n_s + part) * sizeof(float);
  if (static_cast<size_t>(optin) < fixed + 2 * static_cast<size_t>(stage))
    return cudaErrorNotSupported;
  int n = static_cast<int>((optin - fixed) / stage);
  if (n > kMaxStages) n = kMaxStages;
  *out = Layout{stage, n, xin, n_s, static_cast<size_t>(n) * stage + fixed};
  return cudaSuccess;
}

// Shapes the kernel takes: 16-byte rows, a head of 16 to 512 bytes (at most
// one vector per lane), at most kMaxHeads heads.
bool shapes_ok(int es_t, int es_w, int D, int H, int F) {
  if (H <= 0 || H > kMaxHeads || D % H) return false;
  const int Dh = D / H;
  return Dh % 2 == 0 && (D * es_w) % 16 == 0 && (F * es_w) % 16 == 0 && (D * es_t) % 16 == 0 &&
         (F * es_t) % 16 == 0 && (Dh * es_t) % 16 == 0 && Dh % 4 == 0 && Dh <= kMaxHeadDim &&
         Dh / (16 / es_t) <= 32;
}

// The launch plan of one device and shape: the grid (the SM count times the
// blocks per SM that the kernel's shared memory allows) and the shared
// memory a block may take. Found at the first launch, then kept.
struct Plan {
  int dev, D, H, F, C, grid, optin;
};

template <typename T, typename WT>
cudaError_t plan_of(int dev, int D, int H, int F, int C, Plan* out) {
  static std::mutex mu;
  static std::vector<Plan> plans;  // of this kind
  std::lock_guard<std::mutex> lock(mu);
  for (const Plan& q : plans) {
    if (q.dev == dev && q.D == D && q.H == H && q.F == F && q.C == C) {
      *out = q;
      return cudaSuccess;
    }
  }
  int sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  Layout lay;
  e = layout(optin, sizeof(T), sizeof(WT), D, H, F, C, sms, 1, &lay);  // one block per SM
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(stack_kernel<T, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stack_kernel<T, WT>, kBlockThreads,
                                                    lay.smem);
  if (e != cudaSuccess) return e;
  const Plan q{dev, D, H, F, C, sms * per_sm, optin};
  if (per_sm < 1 || q.grid < H || q.grid > kMaxBlocks)
    return cudaErrorNotSupported;
  plans.push_back(q);
  *out = q;
  return cudaSuccess;
}

template <typename T, typename WT>
cudaError_t launch(Params p, cudaStream_t s) {
  if (!shapes_ok(sizeof(T), sizeof(WT), p.D, p.H, p.F)) return cudaErrorNotSupported;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Plan plan;
  e = plan_of<T, WT>(dev, p.D, p.H, p.F, p.C, &plan);
  if (e != cudaSuccess) return e;
  // attention splits per head: about kSlotsPerSplit filled slots each
  // (write_pos of them; the kernel finds the attended ones itself), at
  // most grid / H; one split needs no head barrier
  p.S = (p.write_pos + kSlotsPerSplit - 1) / kSlotsPerSplit;
  if (p.S > plan.grid / p.H) p.S = plan.grid / p.H;
  if (p.S < 1) p.S = 1;
  Layout lay;
  e = layout(plan.optin, sizeof(T), sizeof(WT), p.D, p.H, p.F, p.C, plan.grid, p.S, &lay);
  if (e != cudaSuccess) return e;
  p.stage_bytes = lay.stage_bytes;
  p.n_stages = lay.n_stages;
  p.xin_floats = lay.xin_floats;
  p.vidx_ints = lay.vidx_ints;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.grid);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = lay.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // all blocks resident, or refused
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, stack_kernel<T, WT>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (norms, cache, x and scratch, and the
// weights unless quant). quant: 1 = the four weights are int8 with f32
// per-row scales in_s [L,3D], out_s [L,D], w1_s [L,F], w2_s [L,D]
// (ignored otherwise). x [D] is the stack input on entry and its output on
// return. Weights are row-major per layer: in_proj [L,3D,D], out_proj
// [L,D,D], w1 [L,F,D], w2 [L,D,F]; norms [L,D]; caches [L,C,D]; pos [C] and
// offset [1] int32 on the device; scratch holds 3D + F elements. Weights and
// caches 16-byte aligned.
// One kernel launch on `stream`, on the current device. Returns its
// cudaError_t: cudaErrorNotSupported for shapes the kernel does not take.
extern "C" int decode_stack_run(int dtype, int quant, int L, int D, int H, int F, int C,
                                void* x, const void* in_proj, const void* out_proj,
                                const void* w1, const void* w2, const void* in_s,
                                const void* out_s, const void* w1_s, const void* w2_s,
                                const void* n1s, const void* n1b, const void* n2s,
                                const void* n2b, void* cache_k, void* cache_v, const void* pos,
                                const void* offset, int write_pos, float max_period,
                                void* scratch, void* stream) {
  const int Dh = D / H;
  Params p = {};
  p.L = L;
  p.D = D;
  p.H = H;
  p.F = F;
  p.C = C;
  p.write_pos = write_pos;
  p.rope_c = static_cast<float>(-log(static_cast<double>(max_period)) * 2.0 / Dh);
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  p.x = x;
  p.w[0] = in_proj;
  p.w[1] = out_proj;
  p.w[2] = w1;
  p.w[3] = w2;
  if (quant) {
    p.ws[0] = static_cast<const float*>(in_s);
    p.ws[1] = static_cast<const float*>(out_s);
    p.ws[2] = static_cast<const float*>(w1_s);
    p.ws[3] = static_cast<const float*>(w2_s);
  }
  p.n1s = n1s;
  p.n1b = n1b;
  p.n2s = n2s;
  p.n2b = n2b;
  p.cache_k = cache_k;
  p.cache_v = cache_v;
  p.pos = static_cast<const int*>(pos);
  p.offset = static_cast<const int*>(offset);
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  p.qkv = scratch;
  p.g = static_cast<unsigned char*>(scratch) + 3 * static_cast<size_t>(D) * es;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quant ? launch<float, int8_t>(p, s) : launch<float, float>(p, s);
  return quant ? launch<__nv_bfloat16, int8_t>(p, s) : launch<__nv_bfloat16, __nv_bfloat16>(p, s);
}
