// The stacked int8 GEMV's launch plan (csrc/gemv_stack.cu), for the host and
// the device: the passes over x, the shared-memory layout and each block's
// span of weight rows. Plain C++ apart from the qualifier, so a host
// compiler takes it too (tests/test_torch_gemv_stack.py holds it there).
#pragma once

#ifndef PT_HOST_DEVICE
#ifdef __CUDACC__
#define PT_HOST_DEVICE __host__ __device__
#else
#define PT_HOST_DEVICE
#endif
#endif

namespace pt {

constexpr int kGsTileRows = 64;   // weight rows of a warp's tile: four 16-row mma tiles
constexpr int kGsChunk = 128;     // weight columns (bytes) of a ring stage: one swizzle span
constexpr int kGsStageBytes = kGsTileRows * kGsChunk;
constexpr int kGsMaxGroup = 48;   // rows of x per pass (six 8-row mma tiles)
constexpr int kGsMaxStages = 24;  // ring stages, at most
constexpr int kGsMinStages = 8;   // ring stages, at least: x gives way first
constexpr int kGsFixedBytes = 2048;  // the mbarriers and the ring's 1024-byte alignment

// One launch: x's rows go in `groups` groups of `rows` (at most 8 * nt), its
// columns in `kpasses` passes of kc (a multiple of kGsChunk); every (group,
// column pass) streams the block's weight rows once. x's rows of a pass sit
// in shared memory at a stride of 2 * kc + 16 bytes (so that the mma's B
// fragments read without bank conflicts), after the ring of `stages` stages.
struct GsPlan {
  int groups, rows, nt, kc, kpasses, stages, x_stride;  // rows: x's rows per group
  long long smem;  // dynamic shared memory of a block, in bytes
};

// The plan for R rows of x and I columns (a multiple of 16) within `optin`
// bytes of shared memory a block; smem = 0 when no plan fits.
PT_HOST_DEVICE inline GsPlan gs_plan(int R, int I, int optin) {
  GsPlan p{};
  p.groups = (R + kGsMaxGroup - 1) / kGsMaxGroup;
  p.rows = (R + p.groups - 1) / p.groups;  // balanced groups
  p.nt = (p.rows + 7) / 8;
  const long long room = static_cast<long long>(optin) - kGsFixedBytes -
                         static_cast<long long>(kGsMinStages) * kGsStageBytes;
  long long kc_max = (room / (8 * p.nt) - 16) / 2;  // x fills what the ring leaves
  kc_max -= kc_max % kGsChunk;
  const int i_pad = (I + kGsChunk - 1) / kGsChunk * kGsChunk;
  if (kc_max < kGsChunk) return p;
  p.kc = i_pad < kc_max ? i_pad : static_cast<int>(kc_max);
  p.kpasses = (I + p.kc - 1) / p.kc;
  p.x_stride = 2 * p.kc + 16;
  const long long x_bytes = 8LL * p.nt * p.x_stride;
  long long stages = (optin - kGsFixedBytes - x_bytes) / kGsStageBytes;
  if (stages > kGsMaxStages) stages = kGsMaxStages;
  p.stages = static_cast<int>(stages);
  p.smem = kGsFixedBytes + stages * kGsStageBytes + x_bytes;
  return p;
}

// The first 16-row mma tile of block b's span in a grid of G blocks over
// `tiles` of them (the flat weight's rows / 16, rounded up): contiguous
// spans whose sizes differ by at most one tile, i.e. balanced by bytes.
PT_HOST_DEVICE inline long long gs_span_start(int b, int G, long long tiles) {
  return tiles * b / G;
}

}  // namespace pt
