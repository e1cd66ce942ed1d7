// Threefry-2x32 (20 rounds) and the jax.random derivations built on it,
// for the slot-scan kernel's fault draws; the host side and the plain
// engine use core/threefry.py, which documents the derivations. All
// arithmetic is uint32: the adds wrap and the rotations are funnel
// shifts. A key is two words (x, y), as jax.random keeps it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// the rotation of round j in group i (groups alternate two sets of four)
__host__ __device__ constexpr int tf_rot(int i, int j) {
  return (i & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                 : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint2 c) {
  const unsigned ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  unsigned x0 = c.x + ks[0], x1 = c.y + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, tf_rot(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.fold_in(key, data) for int32 data (its uint32 bit pattern)
__device__ __forceinline__ uint2 tf_fold_in(uint2 k, int data) {
  return threefry2x32(k, make_uint2(0u, static_cast<unsigned>(data)));
}

// The top 16 bits of jax.random.bits(key, (), uint32): the fault model's
// uniform 16-bit draw (faults.py _u16)
__device__ __forceinline__ int tf_u16(uint2 k) {
  const uint2 y = threefry2x32(k, make_uint2(0u, 0u));
  return static_cast<int>((y.x ^ y.y) >> 16);
}
