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

}  // namespace

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
