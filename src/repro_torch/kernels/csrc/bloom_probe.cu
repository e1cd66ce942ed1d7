// Bloom-filter probe: one int8 per key, 1 = possibly weak (nominal
// tRCD), 0 = definitely strong (reduced tRCD).
//
// Replaces the TPU kernel src/repro/kernels/bloom_probe.py (_kernel,
// wrapper bloom_probe), which pins the word array in VMEM and streams
// blocks of 1024 keys through it.
//
// What bounds it on the H100: each key costs k random 4-byte reads of the
// word array plus ~10 integer ops per round; the keys and flags stream
// once. The reads are gathers through L1: a trace's keys are row ids that
// fall on few rows, so they touch a small part of the filter (at the
// paper's 2^20 bits, 128 KiB), and the lines they touch stay in L1. The
// floor is the latency of those gathers on the rows the keys touch, from
// L2 on a line's first touch in an SM, plus the launch.
// Design: no staging. Persistent blocks, up to four per SM, each walk one
// contiguous range of the flattened [B, N] keys (split where a row with
// its own filter begins); the words are read with ld.global.nc through an
// L1 that the kernel asks to be as large as the SM allows. Keys load as
// int4 and flags store as char4, with scalar heads and tails; all k
// hashes of four keys are computed and their 4k word reads issued before
// any is combined. A filter of any size takes the same route (past L1 the
// gathers are served by L2). Words [Bw, W] with Bw in {1, B} and keys
// [B, N] make one launch cover a batch group whose rows carry their own
// filters. The function attributes and the SM count are set and read
// once per process.
#include <cuda_runtime.h>

#include "bloom_hash.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;

// NK keys at once: every index first, then every word read, then the
// tests, so that all NK * K reads are in flight together.
template <int K, int NK>
__device__ __forceinline__ void probe_keys(const uint32_t* __restrict__ w,
                                           const uint32_t (&key)[NK],
                                           uint32_t mask, int8_t (&hit)[NK]) {
  uint32_t idx[NK][K], word[NK][K];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) idx[j][i] = bloom_index(key[j], i, mask);
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) word[j][i] = __ldg(w + (idx[j][i] >> 5));
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    uint32_t all = 1u;
#pragma unroll
    for (int i = 0; i < K; ++i) all &= word[j][i] >> (idx[j][i] & 31u);
    hit[j] = static_cast<int8_t>(all & 1u);
  }
}

// Keys [f0, f1) of the flattened batch against words w: a scalar head up
// to a multiple of 4, int4 groups, a scalar tail.
template <int K>
__device__ __forceinline__ void probe_range(const uint32_t* __restrict__ w,
                                            const int* __restrict__ keys,
                                            int8_t* __restrict__ out,
                                            long long f0, long long f1,
                                            uint32_t mask) {
  const int t = threadIdx.x;
  const long long a = f1 < ((f0 + 3) & ~3LL) ? f1 : ((f0 + 3) & ~3LL);
  const long long e = (f1 & ~3LL) > a ? (f1 & ~3LL) : a;
  const long long g_end = e >> 2;
  long long g = (a >> 2) + t;
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  int4 kv = g < g_end ? __ldg(keys4 + g) : make_int4(0, 0, 0, 0);
  // threads 0-2 take the head, 3-5 the tail
  const long long sf = t < 3 ? f0 + t : e + (t - 3);
  const bool scalar = t < 3 ? sf < a : (t < 6 && sf < f1);
  if (scalar) {
    const uint32_t key[1] = {static_cast<uint32_t>(__ldg(keys + sf))};
    int8_t hit[1];
    probe_keys<K, 1>(w, key, mask, hit);
    out[sf] = hit[0];
  }
  for (; g < g_end; g += blockDim.x) {
    const int4 cur = kv;
    if (g + blockDim.x < g_end) kv = __ldg(keys4 + g + blockDim.x);
    const uint32_t key[4] = {static_cast<uint32_t>(cur.x),
                             static_cast<uint32_t>(cur.y),
                             static_cast<uint32_t>(cur.z),
                             static_cast<uint32_t>(cur.w)};
    int8_t hit[4];
    probe_keys<K, 4>(w, key, mask, hit);
    reinterpret_cast<char4*>(out)[g] =
        make_char4(hit[0], hit[1], hit[2], hit[3]);
  }
}

// One persistent block's range of the B * N keys, each part against the
// filter of its row (the one filter for Bw = 1).
template <int K>
__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const uint32_t* __restrict__ words, int n_words,
                   int words_batched, const int* __restrict__ keys,
                   int8_t* __restrict__ out, long long total, int n,
                   uint32_t mask) {
  const long long G = gridDim.x;
  long long f0 = total * blockIdx.x / G;
  const long long f1 = total * (blockIdx.x + 1) / G;
  while (f0 < f1) {
    const int r = words_batched ? static_cast<int>(f0 / n) : 0;
    long long end = f1;
    if (words_batched && static_cast<long long>(r + 1) * n < end)
      end = static_cast<long long>(r + 1) * n;
    probe_range<K>(words + static_cast<size_t>(r) * n_words, keys, out, f0,
                   end, mask);
    f0 = end;
  }
}

using KernelFn = void (*)(const uint32_t*, int, int, const int*, int8_t*,
                          long long, int, uint32_t);

KernelFn kernel_for(int k) {
  switch (k) {
    case 1: return bloom_probe_kernel<1>;
    case 2: return bloom_probe_kernel<2>;
    case 3: return bloom_probe_kernel<3>;
    case 4: return bloom_probe_kernel<4>;
    case 5: return bloom_probe_kernel<5>;
    case 6: return bloom_probe_kernel<6>;
    case 7: return bloom_probe_kernel<7>;
    case 8: return bloom_probe_kernel<8>;
    default: return nullptr;
  }
}

// Every kernel prefers the largest L1; once per process, for all k.
cudaError_t set_attributes_once() {
  static const cudaError_t err = [] {
    for (int k = 1; k <= 8; ++k) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel_for(k), cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxL1);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return err;
}

// SMs of the current device, read once per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

}  // namespace

// Keys are 16-byte aligned (the wrapper sees to it).
extern "C" int bloom_probe_launch(const void* words, int n_words_batch,
                                  int n_words, const void* keys, void* out,
                                  int batch, int n, int k, int m_bits,
                                  void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  const KernelFn fn = kernel_for(k);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = set_attributes_once();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long total = static_cast<long long>(batch) * n;
  const long long per_block = 4LL * kThreads;
  long long blocks = (total + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  fn<<<static_cast<int>(blocks), kThreads, 0,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, n_words_batch > 1 ? 1 : 0,
      static_cast<const int*>(keys), static_cast<int8_t*>(out), total, n,
      static_cast<uint32_t>(m_bits) - 1u);
  return static_cast<int>(cudaGetLastError());
}
