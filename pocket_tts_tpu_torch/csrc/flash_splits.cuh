// The flash-decode kernel's split of each (b, h) row over the blocks of one
// thread-block cluster (csrc/flash_decode.cu), for the host and the device.
// Plain C++ apart from the qualifier, so a host compiler takes it too
// (tests/test_torch_flash_decode.py holds it there).
#pragma once

#ifndef PT_HOST_DEVICE
#ifdef __CUDACC__
#define PT_HOST_DEVICE __host__ __device__
#else
#define PT_HOST_DEVICE
#endif
#endif

namespace pt {

constexpr int kFdMaxSplits = 8;     // the portable cluster size
constexpr int kFdBlocksPerSm = 4;   // blocks per SM that the splits aim for
constexpr int kFdMaxSlots = 256;    // a split of more attended slots is cut again
constexpr int kFdMinSlots = 32;     // no split gets fewer (one ring stage)

// Blocks per row, the cluster's size: a power of two up to 8. A row is cut
// in two while the grid (rows x splits) gives fewer than kFdBlocksPerSm
// blocks per SM or a split holds more than kFdMaxSlots slots, as long as the
// halves keep kFdMinSlots slots each. `rows` = B x H, `att` the attended
// slots, `sms` the card's SM count.
PT_HOST_DEVICE inline int fd_splits(int rows, int att, int sms) {
  int s = 1;
  while (s < kFdMaxSplits && att >= 2 * s * kFdMinSlots &&
         (static_cast<long long>(rows) * s < static_cast<long long>(kFdBlocksPerSm) * sms ||
          (att + s - 1) / s > kFdMaxSlots))
    s *= 2;
  return s;
}

// The first slot of split r of S: the splits cut [0, att) into consecutive
// ranges whose sizes differ by at most one; split r takes
// fd_split_start(att, S, r) .. fd_split_start(att, S, r + 1) - 1.
PT_HOST_DEVICE inline int fd_split_start(int att, int S, int r) {
  return static_cast<int>(static_cast<long long>(att) * r / S);
}

}  // namespace pt
