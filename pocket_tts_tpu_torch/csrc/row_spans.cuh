// The decode stack's row partition (csrc/decode_stack.cu), for the host and
// the device. Plain C++ apart from the qualifier, so a host compiler takes it
// too (tests/test_torch_decode_stack.py holds it there).
#pragma once

#ifdef __CUDACC__
#define PT_HOST_DEVICE __host__ __device__
#else
#define PT_HOST_DEVICE
#endif

namespace pt {

// The first row of block b's span of product q (0 in_proj [3D, D], 1
// out_proj [D, D], 2 w1 [F, D], 3 w2 [D, F]) in a grid of G blocks: block b
// owns rows span_start(q, b) .. span_start(q, b + 1) - 1 of q in every layer.
// Spans are whole row pairs, so RoPE's rotation pairs stay in one block, and
// are balanced by bytes over the step: each product gives every block the
// same number of pairs, and the rest of its pairs go one each to the next
// blocks of a single walk round the grid that takes the products with the
// longest rows first. The blocks that miss a long pair are then the first to
// get short ones, and none holds more than one long pair above the mean.
PT_HOST_DEVICE inline int span_start(int q, int b, int G, int D, int F) {
  const int order[4] = {F > D ? 3 : 0, F > D ? 0 : 1, F > D ? 1 : 2, F > D ? 2 : 3};
  int first = 0;  // the block that gets the product's first extra pair
  for (int i = 0; i < 4; ++i) {
    const int p = order[i];
    const int pairs = (p == 0 ? 3 * D : (p == 2 ? F : D)) / 2;
    const int base = pairs / G, rest = pairs % G;
    if (p == q) {  // extra pairs of the blocks before b: [first, first + rest) round the grid
      const int end = first + rest;
      int extra = b - first < 0 ? 0 : (b - first < rest ? b - first : rest);
      if (end > G) {
        extra = b - first < 0 ? 0 : (b - first < G - first ? b - first : G - first);
        extra += b < end - G ? b : end - G;
      }
      return 2 * (b * base + extra);
    }
    first = (first + rest) % G;
  }
  return 0;
}

}  // namespace pt
