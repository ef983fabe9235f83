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
// f32. The TPU kernel's online softmax rescales partial value sums and
// divides at the end. In bf16 that cannot give the same bits: a weight's
// rounding needs the row's final max and denominator. So every score of a
// row is known before its first weight is rounded.
//
// Bound on the H100: bytes, the valid k and v rows read once (B=32,
// att=200, H=16, Dh=64 in bf16: ~25 MB, ~7.4 us at 3.35 TB/s).
//
// The attended length att is read from device memory (a CUDA graph of
// several steps replays with the length its own steps advance), so the
// launch is planned for the most it may be, the capacity (at most 4096):
// the split count and each block's shared memory. Every block reads att and
// cuts [0, att) itself.
//
// Design. Each (b, h) row's attended slots [0, att) are cut into S
// consecutive ranges, one block of a thread-block cluster each
// (flash_splits.cuh: S a power of two up to the portable cluster size 8,
// from B*H, the planned length and the SM count, so that a long row is
// spread over several SMs and the card gets several blocks per SM). A
// block of 128 threads
// reads pos for its range and q, then streams its key rows and then its
// value rows through a ring of 4 rounds in shared memory: 16-byte cp.async
// copies of the attended slots only (a slot row at the cache's H*Dh
// stride), each thread waiting for its own copies, so value rounds are in
// flight while the last keys are scored and during the exchange below. A
// group of lanes shuffles a slot's score together. Each block's (max, sum
// of exp) goes to its shared memory; after a cluster barrier every block
// reads the S pairs through distributed shared memory in rank order and
// forms the row's max and denominator (the step's own score included).
// Only then is a weight normalised and rounded, and pass 2 sums w * v in
// f32. Each block writes its partial sum into the leader block's shared
// memory; after a second cluster barrier the leader adds the S partials in
// rank order and round(w_new) * v_new, and stores. One launch, no global
// scratch, no host state a CUDA graph could bake wrongly; every sum is
// taken in a fixed order, so a replay gives the same bits. A block whose
// range holds no attended slot joins both barriers; a row with none gives
// exactly v_new. Dead slots are never copied, so a NaN there cannot leak.
//
// On the H100 a block's chain of dependent steps (pos, the first copies,
// the reductions, the barriers) costs ~5-10 us, so the time is set by how
// many blocks an SM holds while others stream: a ring deep enough for the
// whole range (up to 64 KB a block) was 1.8x slower at B=128 than this
// 4-round ring (PERF.md).
//
// Head dims whose rows are not a power-of-two count of 16-byte pieces, or
// caches not 16-byte aligned, take the narrow body: the same kernel with
// element loads straight from the cache.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "flash_splits.cuh"

namespace {

using namespace pt;
namespace cg = cooperative_groups;

constexpr int kFdThreads = 128;
constexpr int kFdWarps = kFdThreads / 32;
constexpr int kMaxAtt = 4096;
constexpr int kMaxDevices = 64;
// The async body's ring: rounds of one 16-byte piece per thread (2 KB a
// block each). Four keep a block small enough for ~9 blocks per SM, which
// the H100 needs more than a deeper ring (PERF.md: 8, 16 and 32 rounds were
// slower).
constexpr int kRounds = 4;

enum Body { kAsyncBody = 0, kNarrowBody = 1 };

struct FdArgs {
  const void* q;
  const void* kn;
  const void* vn;
  long long q_sb, kn_sb, vn_sb;
  const void* ck;
  const void* cv;
  const int* pos;
  const int* offset;
  void* out;
  const int* att;  // [1] the attended length, clamped to [0, att_max]
  int C, H, Dh, att_max, S, lps;
  float scale;
};

// What one block of a row's cluster works on, and its shared memory after
// the ring: the scores [nmax], this split's (max, sum of exp), the splits'
// value sums [S][Dh] (the leader's), the warps' partial sums
// [kFdWarps][Dh], the attended flags [nmax].
struct Split {
  int b, h, rank, lo, n;
  float* w;
  float* stats;
  float* parts;
  float* wsum;
  unsigned char* ok;
};

__device__ __forceinline__ Split locate(const FdArgs& a, const cg::cluster_group& cluster,
                                        unsigned char* tail) {
  Split s;
  const int row = blockIdx.x / a.S;
  s.b = row / a.H;
  s.h = row % a.H;
  s.rank = static_cast<int>(cluster.block_rank());
  const int att = min(max(__ldg(a.att), 0), a.att_max);
  s.lo = fd_split_start(att, a.S, s.rank);
  s.n = fd_split_start(att, a.S, s.rank + 1) - s.lo;
  const int nmax = (a.att_max + a.S - 1) / a.S;  // the plan's shared memory
  s.w = reinterpret_cast<float*>(tail);
  s.stats = s.w + nmax;
  s.parts = s.stats + 2;
  s.wsum = s.parts + a.S * a.Dh;
  s.ok = reinterpret_cast<unsigned char*>(s.wsum + kFdWarps * a.Dh);
  return s;
}

template <typename T>
__device__ __forceinline__ const T* head_row(const void* base, long long batch_stride,
                                             const Split& s, int Dh) {
  return static_cast<const T*>(base) + s.b * batch_stride + static_cast<long long>(s.h) * Dh;
}

// Two (max, sum of exp(x - max)) summaries as one; (-inf, 0) is empty.
__device__ __forceinline__ void combine(float& m, float& l, float m2, float l2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;
  l = l * expf(m - M) + l2 * expf(m2 - M);
  m = M;
}

// The async body (kAsync): a slot row is P = a.lps 16-byte pieces (a power
// of two <= 32), one per lane of a group of P lanes, so a round covers
// 128 / P slots with one piece per thread. Load j (key round j, then value
// round j - nr) lands by cp.async in the thread's own 16 bytes of ring stage
// j % kRounds, one commit group per load; a thread waits for its own copies
// only, so no block barrier orders the ring. The first kRounds loads are
// issued before anything waits and each consumed load issues the one
// kRounds later, so value rounds are in flight during the last key rounds,
// the exchange and the softmax.
// The narrow body (rows that are not a power-of-two count of 16-byte
// pieces, or caches not 16-byte aligned): element loads straight from the
// cache, a piece being 2 values and a group's lps lanes holding up to 2
// pieces each.
// Every lane holds its slot's score after the group's shuffle sum, keeps a
// running (max, sum of exp) of its group's slots, and in pass 2 forms the
// slot's weight itself from the stored score and the row's max and
// denominator.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kFdThreads) flash_decode_kernel(const FdArgs a) {
  constexpr int V = kAsync ? Vec16<T>::n : 2;  // values per piece
  constexpr int CPL = kAsync ? 1 : 2;          // pieces per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [kRounds][kFdThreads]
  const Split s = locate(a, cluster, smem + (kAsync ? kRounds * kFdThreads * 16 : 0));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int P = a.lps, R = kFdThreads / P, grp = tid / P, lig = tid % P;
  const int Dh = a.Dh, pieces = Dh / V;
  const int nr = (s.n + R - 1) / R, loads = 2 * nr;
  const size_t stride = static_cast<size_t>(a.H) * Dh;  // elements from one slot to the next
  const size_t first = (static_cast<size_t>(s.b) * a.C + s.lo) * stride +
                       static_cast<size_t>(s.h) * Dh + lig * V;
  const T* kb = static_cast<const T*>(a.ck) + first;  // this lane's first piece of the range
  const T* vb = static_cast<const T*>(a.cv) + first;
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring + tid));

  // Load j: this lane's piece of its slot of the round, if that slot is
  // attended.
  auto issue = [&](int j) {
    if (j < loads) {
      const int i = (j < nr ? j : j - nr) * R + grp;
      if (i < s.n && s.ok[i])
        cp_async16<false>(ring_s + (j % kRounds) * kFdThreads * 16,
                          (j < nr ? kb : vb) + i * stride, true);
    }
    cp_async_commit();
  };

  // which slots are attended; q and k_new (before the cache rows, so that
  // they do not queue behind them)
  const int off = a.offset[s.b];
  const int* pr = a.pos + static_cast<size_t>(s.b) * a.C + s.lo;
  for (int i = tid; i < s.n; i += kFdThreads) {
    const int p = pr[i];
    s.ok[i] = p >= 0 && p <= off;
  }
  const T* qr = head_row<T>(a.q, a.q_sb, s, Dh) + lig * V;
  const T* knr = head_row<T>(a.kn, a.kn_sb, s, Dh) + lig * V;
  float qv[CPL][V], sn = 0.f;
#pragma unroll
  for (int ci = 0; ci < CPL; ++ci) {
    const bool in = lig + ci * P < pieces;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      qv[ci][v] = in ? to_f<T>(qr[ci * P * V + v]) : 0.f;
      if (in) sn = fmaf(qv[ci][v], to_f<T>(knr[ci * P * V + v]), sn);
    }
  }
  __syncthreads();

  // Piece ci of this lane in slot i (load j): from the ring, or the cache.
  auto fetch = [&](int j, int i, int ci, float* f) {
    if constexpr (kAsync) {
      Vec16<T>::unpack(ring[(j % kRounds) * kFdThreads + tid], f);
    } else {
      const T* p = (j < nr ? kb : vb) + i * stride + ci * P * V;
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = to_f<T>(p[v]);
    }
  };
  if constexpr (kAsync) {
#pragma unroll
    for (int j = 0; j < kRounds; ++j) issue(j);
  }
  for (int o = P / 2; o > 0; o >>= 1) sn += __shfl_xor_sync(0xffffffffu, sn, o);
  sn *= a.scale;  // the step's own score, the same in every group and block

  // pass 1: the scores (every lane runs every round, so a group's shuffles
  // see all of its lanes)
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < nr; ++j) {
    if constexpr (kAsync) cp_async_wait<kRounds - 1>();
    const int i = j * R + grp;
    const bool valid = i < s.n && s.ok[i];
    float acc = 0.f;
    if (valid) {
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        if (lig + ci * P < pieces) {
          float f[V];
          fetch(j, i, ci, f);
#pragma unroll
          for (int v = 0; v < V; ++v) acc = fmaf(qv[ci][v], f[v], acc);
        }
      }
    }
    for (int o = P / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (valid) {
      const float x = acc * a.scale;
      if (lig == 0) s.w[i] = x;
      combine(m, l, x, 1.f);
    }
    if constexpr (kAsync) issue(j + kRounds);
  }

  // this split's (max, sum of exp): the groups of a warp by shuffles, the
  // warps in order; then the row's over the cluster, read from each block's
  // shared memory in rank order
  for (int o = P; o < 32; o <<= 1)
    combine(m, l, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, l, o));
  float* red = s.wsum;  // idle until pass 2 ends
  if (lane == 0) {
    red[2 * warp] = m;
    red[2 * warp + 1] = l;
  }
  __syncthreads();
  m = red[0];
  l = red[1];
  for (int w = 1; w < kFdWarps; ++w) combine(m, l, red[2 * w], red[2 * w + 1]);
  float M = sn, den = 0.f;
  if (a.S == 1) {
    M = fmaxf(M, m);
    if (l > 0.f) den = l * expf(m - M);
  } else {
    if (tid == 0) {
      s.stats[0] = m;
      s.stats[1] = l;
    }
    cluster.sync();
    float rm = -INFINITY, rl = 0.f;
    if (lane < a.S) {
      const float* st = cluster.map_shared_rank(s.stats, lane);
      rm = st[0];
      rl = st[1];
    }
    for (int r = 0; r < a.S; ++r) M = fmaxf(M, __shfl_sync(0xffffffffu, rm, r));
    for (int r = 0; r < a.S; ++r) {
      const float mr = __shfl_sync(0xffffffffu, rm, r), lr = __shfl_sync(0xffffffffu, rl, r);
      if (lr > 0.f) den += lr * expf(mr - M);
    }
  }
  const float en = expf(sn - M);
  den += en;
  const float wn = round_t<T>(en / den);

  // pass 2: this lane's pieces of the sum of w * v over its group's slots,
  // each weight normalised by the row's denominator and rounded to the
  // cache dtype
  float acc[CPL][V];
#pragma unroll
  for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[ci][v] = 0.f;
  for (int j = nr; j < loads; ++j) {
    if constexpr (kAsync) cp_async_wait<kRounds - 1>();
    const int i = (j - nr) * R + grp;
    if (i < s.n && s.ok[i]) {
      const float wc = round_t<T>(expf(s.w[i] - M) / den);
#pragma unroll
      for (int ci = 0; ci < CPL; ++ci) {
        if (lig + ci * P < pieces) {
          float f[V];
          fetch(j, i, ci, f);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[ci][v] = fmaf(wc, f[v], acc[ci][v]);
        }
      }
    }
    if constexpr (kAsync) issue(j + kRounds);
  }

  // the block's sum: the groups of a warp by shuffles, then the warps in
  // order; the leader adds the splits' sums in rank order and
  // round(w_new) * v_new, and stores
#pragma unroll
  for (int ci = 0; ci < CPL; ++ci)
#pragma unroll
    for (int v = 0; v < V; ++v)
      for (int o = P; o < 32; o <<= 1) acc[ci][v] += __shfl_xor_sync(0xffffffffu, acc[ci][v], o);
  __syncthreads();  // every lane is done with red
  if (lane < P) {
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci) {
      const int piece = lig + ci * P;
      if (piece < pieces) {
#pragma unroll
        for (int v = 0; v < V; ++v) s.wsum[warp * Dh + piece * V + v] = acc[ci][v];
      }
    }
  }
  __syncthreads();
  float* lead = a.S == 1 ? s.parts : cluster.map_shared_rank(s.parts, 0);
  for (int d = tid; d < Dh; d += kFdThreads) {
    float sum = s.wsum[d];
    for (int w = 1; w < kFdWarps; ++w) sum += s.wsum[w * Dh + d];
    lead[s.rank * Dh + d] = sum;
  }
  if (a.S == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  if (s.rank == 0) {
    const T* vnr = head_row<T>(a.vn, a.vn_sb, s, Dh);
    T* o = static_cast<T*>(a.out) + (static_cast<size_t>(s.b) * a.H + s.h) * Dh;
    for (int d = tid; d < Dh; d += kFdThreads) {
      float sum = 0.f;
      for (int r = 0; r < a.S; ++r) sum += s.parts[r * Dh + d];
      o[d] = from_f<T>(sum + wn * to_f<T>(vnr[d]));
    }
  }
}

// ------------------------------------------------------------------- host

struct Plan {
  int splits, body, lps;
  size_t smem;
};

int pow2_at_most(int n) {
  int p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}

int sm_count(int dev) {
  static int sms[kMaxDevices] = {};
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// The launch for one call: the splits (flash_splits.cuh), the body, the
// lanes per slot and the shared memory a block takes.
Plan make_plan(int es, int B, int H, int Dh, int att, const void* ck, const void* cv, int sms) {
  Plan p = {};
  const int rowbytes = Dh * es, pieces = rowbytes / 16;
  const bool async = rowbytes % 16 == 0 && pieces <= 32 && (pieces & (pieces - 1)) == 0 &&
                     reinterpret_cast<uintptr_t>(ck) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cv) % 16 == 0;
  p.body = async ? kAsyncBody : kNarrowBody;
  p.splits = fd_splits(B * H, att, sms);
  p.lps = async ? pieces : pow2_at_most(Dh / 2 < 32 ? Dh / 2 : 32);
  const int nmax = (att + p.splits - 1) / p.splits;
  p.smem = (async ? kRounds * kFdThreads * 16 : 0) +
           4 * static_cast<size_t>(nmax + 2 + (p.splits + kFdWarps) * Dh) + nmax;
  return p;
}

// The kernel a plan launches, its shared-memory limit raised to the plan's
// need (once per device and size, so a later launch may be captured in a
// CUDA graph).
template <typename T, bool kAsync>
cudaError_t ready(const Plan& p, int dev, const void** kern) {
  static size_t raised[kMaxDevices] = {};
  *kern = reinterpret_cast<const void*>(flash_decode_kernel<T, kAsync>);
  if (p.smem <= raised[dev]) return cudaSuccess;
  const cudaError_t e = allow_smem(flash_decode_kernel<T, kAsync>, p.smem);
  if (e == cudaSuccess) raised[dev] = p.smem;
  return e;
}

template <typename T>
cudaError_t kernel_for(const Plan& p, int dev, const void** kern) {
  return p.body == kAsyncBody ? ready<T, true>(p, dev, kern) : ready<T, false>(p, dev, kern);
}

// The grid: the B * H rows' clusters of p.splits blocks each.
cudaLaunchConfig_t launch_config(const Plan& p, int rows, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * p.splits));
  cfg.blockDim = dim3(kFdThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan of a call and its kernel, ready to launch.
cudaError_t prepare(int dtype, int B, int H, int Dh, int att, const void* ck, const void* cv,
                    Plan* p, const void** kern, int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *p = make_plan(dtype == 0 ? 4 : 2, B, H, Dh, att, ck, cv, sm_count(*dev));
  return dtype == 0 ? kernel_for<float>(*p, *dev, kern)
                    : kernel_for<__nv_bfloat16>(*p, *dev, kern);
}

bool takes(int Dh, int C) { return Dh > 0 && Dh % 2 == 0 && Dh <= 128 && C >= 0; }

// The launch is planned for the most slots a call may attend.
int planned_att(int C) { return C < kMaxAtt ? C : kMaxAtt; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, caches and out alike).
// q/k_new/v_new: [B,H,Dh] with the given batch strides (elements), heads
// contiguous; caches [B,C,H,Dh] contiguous; pos [B,C] and offset [B] int32;
// att [1] int32 on the device, the slots attended, 0 <= att <= min(C, 4096)
// (clamped into that range); out [B,H,Dh]. Even Dh <= 128. One launch on
// `stream`, planned for att = min(C, 4096); returns its cudaError_t
// (cudaErrorInvalidValue for a case it does not take, the launch's own
// error for one the card refuses).
extern "C" int flash_decode_run(int dtype, int B, int H, int Dh, int C, const void* att,
                                const void* q,
                                long long q_sb, const void* kn, long long kn_sb, const void* vn,
                                long long vn_sb, const void* ck, const void* cv, const void* pos,
                                const void* offset, void* out, void* stream) {
  if (!takes(Dh, C)) return cudaErrorInvalidValue;
  Plan p = {};
  const void* kern = nullptr;
  int dev = 0;
  cudaError_t e = prepare(dtype, B, H, Dh, planned_att(C), ck, cv, &p, &kern, &dev);
  if (e != cudaSuccess) return e;
  FdArgs a;
  a.q = q;
  a.kn = kn;
  a.vn = vn;
  a.q_sb = q_sb;
  a.kn_sb = kn_sb;
  a.vn_sb = vn_sb;
  a.ck = ck;
  a.cv = cv;
  a.pos = static_cast<const int*>(pos);
  a.offset = static_cast<const int*>(offset);
  a.out = out;
  a.C = C;
  a.H = H;
  a.Dh = Dh;
  a.att = static_cast<const int*>(att);
  a.att_max = planned_att(C);
  a.S = p.splits;
  a.lps = p.lps;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(p, B * H, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {&a};
  e = cudaLaunchKernelExC(&cfg, kern, args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The launch flash_decode_run makes for these arguments, into plan[3]:
// splits (the cluster's size), body (0 async, 1 narrow) and shared bytes
// per block.
extern "C" int flash_decode_plan(int dtype, int B, int H, int Dh, int C, const void* ck,
                                 const void* cv, int* plan) {
  if (!takes(Dh, C)) return cudaErrorInvalidValue;
  Plan p = {};
  const void* kern = nullptr;
  int dev = 0;
  const cudaError_t e = prepare(dtype, B, H, Dh, planned_att(C), ck, cv, &p, &kern, &dev);
  plan[0] = p.splits;
  plan[1] = p.body;
  plan[2] = static_cast<int>(p.smem);
  return e;
}
