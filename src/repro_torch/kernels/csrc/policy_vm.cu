// Batch policy-VM scoring: packed tables [P, L + 1, 4] over one shared
// environment [N_LOADS, Q] -> [P, 3, Q] int32 (score, boost, mitigate).
//
// Replaces the TPU kernel src/repro/kernels/policy_vm.py (_kernel,
// wrapper policy_vm_scores), one grid cell per program with the table
// and the environment in VMEM.
//
// What bounds it on the H100: about L * 15 integer operations per
// (program, lane) and a few hundred bytes per program, so neither the
// memory nor the ALUs are near a limit at the sizes a sweep uses; the
// time is launch latency plus the serial chain of L rows per lane.
// Design: one block per program, one thread per queue lane (lanes past
// the block loop); the table is staged in shared memory, the lane's
// environment and its L SSA values in registers / local memory. The VM
// body is policy_vm_lane in policy_vm.cuh, the same code slot_scan runs.
// A table longer than REPRO_VM_MAX_L (the reference's table_bucket has no
// cap) takes the wide instantiation: 32 threads a block, the table read
// from global memory, each thread's L values interleaved across the block
// in dynamic shared memory where 32 * L ints fit, else in global scratch
// that the wrapper allocates (policy_vm_wide_scratch_ints).
#include <cuda_runtime.h>

#include "policy_vm.cuh"

namespace {

__global__ void policy_vm_kernel(const int* __restrict__ tables, int L,
                                 const int* __restrict__ env, int q,
                                 int* __restrict__ out) {
  extern __shared__ int s_table[];
  const int p = blockIdx.x;
  const int n_tab = (L + 1) * 4;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x)
    s_table[i] = tables[static_cast<size_t>(p) * n_tab + i];
  __syncthreads();
  int vals[REPRO_VM_MAX_L];
  int lane_env[REPRO_N_LOADS];
  int* o = out + static_cast<size_t>(p) * 3 * q;
  for (int lane = threadIdx.x; lane < q; lane += blockDim.x) {
    for (int j = 0; j < REPRO_N_LOADS; ++j) lane_env[j] = env[j * q + lane];
    int score, boost, mit;
    policy_vm_lane(s_table, L, lane_env, vals, &score, &boost, &mit);
    o[lane] = score;
    o[q + lane] = boost;
    o[2 * q + lane] = mit;
  }
}

constexpr int kWideThreads = 32;

__global__ void __launch_bounds__(kWideThreads)
policy_vm_wide_kernel(const int* __restrict__ tables, int L,
                      const int* __restrict__ env, int q,
                      int* __restrict__ out, int* __restrict__ scratch) {
  extern __shared__ int s_vals[];
  const int p = blockIdx.x;
  const int* table = tables + static_cast<size_t>(p) * (L + 1) * 4;
  int* vals = (scratch != nullptr
                   ? scratch + static_cast<size_t>(p) * kWideThreads * L
                   : s_vals) +
              threadIdx.x;
  int lane_env[REPRO_N_LOADS];
  int* o = out + static_cast<size_t>(p) * 3 * q;
  for (int lane = threadIdx.x; lane < q; lane += kWideThreads) {
    for (int j = 0; j < REPRO_N_LOADS; ++j) lane_env[j] = env[j * q + lane];
    int score, boost, mit;
    policy_vm_lane(table, L, lane_env, vals, &score, &boost, &mit,
                   kWideThreads);
    o[lane] = score;
    o[q + lane] = boost;
    o[2 * q + lane] = mit;
  }
}

size_t wide_vals_bytes(int L) {
  return static_cast<size_t>(kWideThreads) * L * sizeof(int);
}

}  // namespace

// Global scratch (ints) the wide instantiation needs for n_programs tables
// of L rows: 0 when every block's VM values fit in shared memory.
extern "C" long long policy_vm_wide_scratch_ints(int n_programs, int L) {
  if (wide_vals_bytes(L) <= REPRO_MAX_DYN_SMEM) return 0;
  return static_cast<long long>(n_programs) * kWideThreads * L;
}

extern "C" int policy_vm_wide_launch(const void* tables, int n_programs,
                                     int L, const void* env, int q,
                                     void* out, void* scratch,
                                     void* stream) {
  if (n_programs <= 0 || q <= 0) return 0;
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = wide_vals_bytes(L);
    const cudaError_t e = cudaFuncSetAttribute(
        policy_vm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  policy_vm_wide_kernel<<<n_programs, kWideThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tables), L, static_cast<const int*>(env), q,
      static_cast<int*>(out), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int policy_vm_launch(const void* tables, int n_programs, int L,
                                const void* env, int q, void* out,
                                void* stream) {
  if (n_programs <= 0 || q <= 0) return 0;
  const int threads = q < 256 ? q : 256;
  const size_t smem = static_cast<size_t>(L + 1) * 4 * sizeof(int);
  policy_vm_kernel<<<n_programs, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tables), L, static_cast<const int*>(env), q,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
