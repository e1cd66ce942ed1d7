// Shared helpers for the emulator's CUDA kernels.
//
// The reference semantics are int32 with two's-complement wraparound
// (XLA's integer arithmetic). Signed overflow is undefined in C++, so
// every sum or product that may wrap goes through uint32 and back.
#pragma once

#include <cstdint>

#define REPRO_BIG (1 << 30)
// dynamic shared memory one block may opt into on the H100 (227 KB)
#define REPRO_MAX_DYN_SMEM 232448

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Python / numpy floor division (C++ '/' truncates toward zero).
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// Python / numpy floor modulo for n > 0: -6 mod 16 is 10, not -6.
__device__ __forceinline__ int floormod(int a, int n) {
  return ((a % n) + n) % n;
}
