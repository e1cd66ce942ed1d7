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
// Design: 16-byte vector loads and stores, grid-stride, when both base
// pointers (and, for strided rows, the row size and stride) are 16-byte
// aligned; a contiguous copy runs as one flat row whose last size % 16
// bytes are a scalar tail. Anything else falls back to a byte loop in
// the same kernel template. Exact by construction.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

template <typename U>
__global__ void __launch_bounds__(kThreads)
rowclone_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     long long rows, long long units, long long src_stride,
                     long long dst_stride, int tail) {
  const long long total = rows * units;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / units;
    const long long c = i - r * units;
    reinterpret_cast<U*>(dst + r * dst_stride)[c] =
        reinterpret_cast<const U*>(src + r * src_stride)[c];
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    // rows == 1 here: the bytes after the last whole unit
    const long long off = units * static_cast<long long>(sizeof(U)) + threadIdx.x;
    dst[off] = src[off];
  }
}

template <typename U>
int launch(const void* src, void* dst, long long rows, long long units,
           long long src_stride, long long dst_stride, int tail,
           cudaStream_t stream) {
  long long blocks = (rows * units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  rowclone_copy_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), rows, units,
      src_stride, dst_stride, tail);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: `rows` contiguous rows of `row_bytes`; dst: rows `dst_stride`
// bytes apart. Returns cudaGetLastError() after the launch (0 on
// success); nothing is launched for an empty copy.
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
