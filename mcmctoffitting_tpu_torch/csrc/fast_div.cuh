// Division of a 32-bit index by a divisor that is fixed for a launch, by a
// multiplication (Granlund and Montgomery, "Division by invariant integers
// using multiplication", 1994, figure 4.1: exact for every 32-bit n).  The
// host derives the multiplier once per launch; the device divides in five
// instructions where a division by a run-time divisor takes ~25.
#pragma once

#include <cstdint>

namespace mcmctof {

struct FastDiv {
  uint32_t d, m, sh1, sh2;

  explicit FastDiv(uint32_t divisor) : d(divisor) {
    uint32_t l = 0;   // ceil(log2(d))
    while (l < 32 && (1ull << l) < d) ++l;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
    sh1 = l < 1 ? l : 1;
    sh2 = l > 1 ? l - 1 : 0;
  }

  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    const uint32_t t = __umulhi(m, n);
    return (t + ((n - t) >> sh1)) >> sh2;
  }

  __device__ __forceinline__ uint32_t mod(uint32_t n) const {
    return n - div(n) * d;
  }
};

}  // namespace mcmctof
