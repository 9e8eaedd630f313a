// Philox4x32-10 counter-based generator (Salmon, Moraes, Dror, Shaw,
// "Parallel random numbers: as easy as 1, 2, 3", SC'11; the constants of
// Random123).  Twin of mcmctoffitting_tpu_torch/ops/poisson.py::philox4x32_10.
#pragma once

#include <cstdint>

namespace mcmctof {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// top 24 bits -> [0, 1), exact in float32
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

}  // namespace mcmctof
