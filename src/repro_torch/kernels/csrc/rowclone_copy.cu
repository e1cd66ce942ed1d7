// Bulk copy of a contiguous [R, C] tensor of any dtype, byte for byte,
// optionally into rows that lie `dst_stride` bytes apart (a slot of a
// larger tensor): the serving engine's KV-page fork writes each copy of a
// [G, 1, ...] cache leaf straight into its slot of the [G, n, ...] output.
//
// Replaces the TPU kernel src/repro/kernels/rowclone_copy.py (_kernel,
// wrapper rowclone_copy), which streams (block_rows, C) tiles HBM -> VMEM
// -> HBM and never touches the vector units: the TPU analogue of an
// in-DRAM RowClone copy.
//
// What bounds it on the H100: bytes only, each byte read once and written
// once (2 x bytes over 3.35 TB/s; the fork's 77 MB cache leaf: ~46 us).
// Design: the copy is cut into chunks of kThreads x kUnroll units (16
// bytes each when both bases, and for strided rows the row size and the
// stride, are 16-byte aligned; else single bytes), each chunk inside one
// row, and a block copies one chunk: it finds the chunk's row once, never
// per unit. Each thread issues kUnroll independent loads before its
// stores, with streaming cache hints because every byte is touched once
// (loads that skip L1 and fetch whole 256-byte L2 lines, evict-first
// stores); the card keeps 8 blocks of 256 threads on each SM, 128 KB of
// loads in flight per SM, enough to cover HBM latency. (A persistent
// grid of SM count x resident blocks walking the chunks, and a TMA bulk
// copy through a ring of shared-memory buffers, both measured slower on
// the fork leaf.) A contiguous copy runs as one flat row whose last
// size % 16 bytes are a scalar tail. Exact by construction.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = static_cast<long long>(kThreads) * kUnroll;

// read once: no L1 allocation, and L2 fetches the whole 256-byte line
__device__ __forceinline__ int4 load_once(const int4* p) {
  int4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ void store_once(int4* p, int4 v) { __stcs(p, v); }
__device__ __forceinline__ uint8_t load_once(const uint8_t* p) {
  return __ldcs(p);
}
__device__ __forceinline__ void store_once(uint8_t* p, uint8_t v) {
  __stcs(p, v);
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
rowclone_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     long long units, long long chunks_per_row,
                     long long n_chunks, long long src_stride,
                     long long dst_stride, int tail) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const long long r = c / chunks_per_row;
    const long long u0 = (c - r * chunks_per_row) * kChunk + threadIdx.x;
    const U* s = reinterpret_cast<const U*>(src + r * src_stride);
    U* d = reinterpret_cast<U*>(dst + r * dst_stride);
    U v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = u0 + k * kThreads;
      if (u < units) v[k] = load_once(s + u);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = u0 + k * kThreads;
      if (u < units) store_once(d + u, v[k]);
    }
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    // one row here: the bytes after the last whole unit
    const long long off = units * static_cast<long long>(sizeof(U)) + threadIdx.x;
    dst[off] = src[off];
  }
}

template <typename U>
int launch(const void* src, void* dst, long long rows, long long units,
           long long src_stride, long long dst_stride, int tail,
           cudaStream_t stream) {
  const long long chunks_per_row = (units + kChunk - 1) / kChunk;
  const long long n_chunks = rows * chunks_per_row;
  long long blocks = n_chunks;   // one chunk each; the loop covers the rest
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  if (blocks < 1) blocks = 1;
  rowclone_copy_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), units,
      chunks_per_row, n_chunks, src_stride, dst_stride, tail);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: `rows` contiguous rows of `row_bytes`; dst: rows `dst_stride`
// bytes apart. Returns the CUDA error of the launch (0 on success);
// nothing is launched for an empty copy.
extern "C" int rowclone_copy_launch(const void* src, void* dst,
                                    long long rows, long long row_bytes,
                                    long long dst_stride, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dst_stride == row_bytes) {  // one contiguous run
    row_bytes *= rows;
    rows = 1;
  }
  const bool aligned =
      reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
      (rows == 1 || (row_bytes % 16 == 0 && dst_stride % 16 == 0));
  if (aligned) {
    const int tail = rows == 1 ? static_cast<int>(row_bytes % 16) : 0;
    return launch<int4>(src, dst, rows, row_bytes / 16, row_bytes, dst_stride,
                        tail, s);
  }
  return launch<uint8_t>(src, dst, rows, row_bytes, row_bytes, dst_stride, 0, s);
}
