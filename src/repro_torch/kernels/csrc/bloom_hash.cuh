// The Bloom filter's k hash functions (core/bloom.py), shared by the
// bloom_probe kernel and the reference engine's in-slot probe (ref_scan).
// Hash i of a uint32 key is a bit index below m_bits (a power of two):
// two xor-shift-multiply rounds, the first by the i-th multiplier.
#pragma once

#include <cstdint>

namespace {

__device__ const uint32_t kMuls[8] = {0x85EBCA6Bu, 0xC2B2AE35u, 0x27D4EB2Fu,
                                      0x165667B1u, 0x9E3779B1u, 0x85EBCA77u,
                                      0xC2B2AE3Du, 0x27D4EB2Du};

__device__ __forceinline__ uint32_t bloom_index(uint32_t key, int i,
                                                uint32_t mask) {
  uint32_t x = key;
  x ^= x >> 16;
  x *= kMuls[i];
  x ^= x >> 13;
  x *= 0x2B2AE3D5u;
  x ^= x >> 16;
  return x & mask;
}

}  // namespace
