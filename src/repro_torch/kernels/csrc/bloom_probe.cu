// Bloom-filter probe: one int8 per key, 1 = possibly weak (nominal
// tRCD), 0 = definitely strong (reduced tRCD).
//
// Replaces the TPU kernel src/repro/kernels/bloom_probe.py (_kernel,
// wrapper bloom_probe), which pins the word array in VMEM and streams
// blocks of 1024 keys through it.
//
// What bounds it on the H100: each key costs k dependent random 4-byte
// reads of the word array plus ~10 integer ops per round; the keys and
// flags stream once. At the paper's 2^20-bit filter the array is 128 KiB,
// so the reads are latency-bound gathers, not bandwidth.
// Design: the word array is staged once per block in shared memory when
// it fits (m_bits/8 <= 200 KiB; the H100 gives a block up to 227 KB after
// cudaFuncSetAttribute), and every block walks many keys grid-stride so
// the staging is amortized; larger filters read global memory (L2).
// Words [Bw, W] with Bw in {1, B} and keys [B, N] make one launch cover a
// batch group whose rows carry their own filters.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ const uint32_t kMuls[8] = {0x85EBCA6Bu, 0xC2B2AE35u, 0x27D4EB2Fu,
                                      0x165667B1u, 0x9E3779B1u, 0x85EBCA77u,
                                      0xC2B2AE3Du, 0x27D4EB2Du};

constexpr int kThreads = 1024;
constexpr int kSmemLimit = 200 * 1024;

__device__ __forceinline__ int8_t probe_one(const uint32_t* words, uint32_t key,
                                            int k, uint32_t mask) {
  bool hit = true;
  for (int i = 0; i < k; ++i) {
    uint32_t x = key;
    x ^= x >> 16;
    x *= kMuls[i];
    x ^= x >> 13;
    x *= 0x2B2AE3D5u;
    x ^= x >> 16;
    const uint32_t idx = x & mask;
    hit = hit && (((words[idx >> 5] >> (idx & 31u)) & 1u) == 1u);
  }
  return hit ? 1 : 0;
}

template <bool kShared>
__global__ void bloom_probe_kernel(const uint32_t* __restrict__ words,
                                   int n_words, int words_batched,
                                   const uint32_t* __restrict__ keys,
                                   int8_t* __restrict__ out, int n, int k,
                                   uint32_t mask) {
  extern __shared__ uint32_t s_words[];
  const int b = blockIdx.y;
  const uint32_t* w = words + (words_batched ? static_cast<size_t>(b) * n_words : 0);
  if (kShared) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_words[i] = w[i];
    __syncthreads();
    w = s_words;
  }
  const uint32_t* kb = keys + static_cast<size_t>(b) * n;
  int8_t* ob = out + static_cast<size_t>(b) * n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    ob[i] = probe_one(w, kb[i], k, mask);
  }
}

}  // namespace

extern "C" int bloom_probe_launch(const void* words, int n_words_batch,
                                  int n_words, const void* keys, void* out,
                                  int batch, int n, int k, int m_bits,
                                  void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  const size_t smem = static_cast<size_t>(n_words) * sizeof(uint32_t);
  const int per_row = (n + kThreads - 1) / kThreads;
  const int spread = (132 + batch - 1) / batch;  // fill the SMs across rows
  dim3 grid(per_row < spread ? per_row : spread, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int batched = n_words_batch > 1 ? 1 : 0;
  const uint32_t mask = static_cast<uint32_t>(m_bits) - 1u;
  if (smem <= kSmemLimit) {
    cudaError_t e = cudaFuncSetAttribute(
        bloom_probe_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    bloom_probe_kernel<true><<<grid, kThreads, smem, s>>>(
        static_cast<const uint32_t*>(words), n_words, batched,
        static_cast<const uint32_t*>(keys), static_cast<int8_t*>(out), n, k,
        mask);
  } else {
    bloom_probe_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(words), n_words, batched,
        static_cast<const uint32_t*>(keys), static_cast<int8_t*>(out), n, k,
        mask);
  }
  return static_cast<int>(cudaGetLastError());
}
