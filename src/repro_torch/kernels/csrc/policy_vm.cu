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
// time is launch latency, the table's decode and the chain of the
// program's rows per lane.
// Design: one block per program. Its first warp decodes the table once
// (policy_vm.cuh: loads and constants run no instruction, rows no header
// register reaches are dropped); then each thread evaluates kLanes queue
// lanes as interleaved chains, its values and environment in shared
// memory interleaved across the block, so that every access of a warp is
// conflict-free. The decode and the evaluation are those slot_scan runs.
// Tables of up to REPRO_VM_MAX_L rows run the fast instantiation (two
// lanes a thread, up to 8 warps a block); longer tables, which the
// reference's table_bucket allows, the wide one: one warp, one lane a
// thread, its region in dynamic shared memory where it fits in 227 KB,
// else in global scratch that the wrapper allocates
// (policy_vm_wide_scratch_ints).
#include <cuda_runtime.h>

#include "policy_vm.cuh"

namespace {

template <int kLanes, bool kShared>
__global__ void policy_vm_kernel(const int* __restrict__ tables, int L,
                                 VmLayout lay, const int* __restrict__ env,
                                 int q, int* __restrict__ out,
                                 int* __restrict__ scratch) {
  extern __shared__ int4 vm_smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int cols = T * kLanes;
  const int* table = tables + static_cast<size_t>(p) * (L + 1) * 4;
  int* vm = kShared ? reinterpret_cast<int*>(vm_smem)
                    : scratch + static_cast<size_t>(p) * lay.total;
  int col[kLanes];
#pragma unroll
  for (int h = 0; h < kLanes; ++h) col[h] = h * T + tid;
  // the lanes' environment, loaded while the table is staged and decoded
  int ev[kLanes][REPRO_N_LOADS];
  auto load_env = [&](int base) {
#pragma unroll
    for (int h = 0; h < kLanes; ++h)
#pragma unroll
      for (int s = 0; s < REPRO_N_LOADS; ++s)
        ev[h][s] =
            base + col[h] < q ? __ldg(env + s * q + base + col[h]) : 0;
  };
  load_env(0);
  vm_stage(table, L, vm, lay, tid, T);
  __syncthreads();
  if (tid < 32) vm_decode(table, L, cols, vm, lay);
  __syncthreads();
  int* vals = vm + lay.o_vals;
  const int2* consts = reinterpret_cast<const int2*>(vm + lay.o_const);
  const int n_const = vm[repro_vm::kHConst];
  const unsigned mask = static_cast<unsigned>(vm[repro_vm::kHEnv]);
#pragma unroll
  for (int h = 0; h < kLanes; ++h) {
    vals[repro_vm::kZero * cols + col[h]] = 0;
    for (int k = 0; k < n_const; ++k)
      vals[consts[k].x + col[h]] = consts[k].y;
  }
  const int4* prog = reinterpret_cast<const int4*>(vm + vm[repro_vm::kHProg]);
  const int n_exec = vm[repro_vm::kHExec];
  const int o_score = vm[repro_vm::kHScore];
  const int o_boost = vm[repro_vm::kHBoost];
  const int o_mit = vm[repro_vm::kHMit];
  int* o = out + static_cast<size_t>(p) * 3 * q;
  for (int base = 0; base < q; base += cols) {
#pragma unroll
    for (int h = 0; h < kLanes; ++h)
#pragma unroll
      for (int s = 0; s < REPRO_N_LOADS; ++s)
        if ((mask >> s) & 1u) vals[s * cols + col[h]] = ev[h][s];
    if (base + cols < q) load_env(base + cols);
    vm_run<kLanes>(prog, n_exec, vals, col);
#pragma unroll
    for (int h = 0; h < kLanes; ++h) {
      const int lane = base + col[h];
      if (lane < q) {
        o[lane] = vals[o_score + col[h]];
        o[q + lane] = vals[o_boost + col[h]];
        o[2 * q + lane] = vals[o_mit + col[h]];
      }
    }
  }
}

constexpr int kFastLanes = 2;
constexpr int kMaxWarps = 8;

// Opt a kernel into the largest dynamic shared memory, once per process.
template <typename K>
cudaError_t allow_max_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              REPRO_MAX_DYN_SMEM);
}

const cudaError_t& fast_attr() {
  static const cudaError_t e =
      allow_max_smem(policy_vm_kernel<kFastLanes, true>);
  return e;
}

const cudaError_t& wide_attr() {
  static const cudaError_t e = allow_max_smem(policy_vm_kernel<1, true>);
  return e;
}

size_t wide_bytes(int L) {
  const VmLayout lay = vm_layout(L, 32);
  return lay.total < 0 ? ~size_t{0} : static_cast<size_t>(lay.total) * 4;
}

}  // namespace

// Global scratch (ints) the wide instantiation needs for n_programs tables
// of L rows: 0 when a block's region fits in shared memory, -1 when it
// cannot be indexed with an int.
extern "C" long long policy_vm_wide_scratch_ints(int n_programs, int L) {
  const VmLayout lay = vm_layout(L, 32);
  if (lay.total < 0) return -1;
  if (wide_bytes(L) <= REPRO_MAX_DYN_SMEM) return 0;
  return static_cast<long long>(n_programs) * lay.total;
}

extern "C" int policy_vm_wide_launch(const void* tables, int n_programs,
                                     int L, const void* env, int q,
                                     void* out, void* scratch,
                                     void* stream) {
  if (n_programs <= 0 || q <= 0) return 0;
  const VmLayout lay = vm_layout(L, 32);
  if (lay.total < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* e = static_cast<const int*>(env);
  int* o = static_cast<int*>(out);
  if (scratch == nullptr) {
    if (wide_bytes(L) > REPRO_MAX_DYN_SMEM)
      return static_cast<int>(cudaErrorInvalidValue);
    if (wide_attr() != cudaSuccess) return static_cast<int>(wide_attr());
    policy_vm_kernel<1, true><<<n_programs, 32, wide_bytes(L), s>>>(
        t, L, lay, e, q, o, nullptr);
  } else {
    policy_vm_kernel<1, false><<<n_programs, 32, 0, s>>>(
        t, L, lay, e, q, o, static_cast<int*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}

// The fast instantiation (L <= REPRO_VM_MAX_L): as many warps as two lanes
// a thread need, at most kMaxWarps, and fewer where their values would
// not fit in shared memory.
extern "C" int policy_vm_launch(const void* tables, int n_programs, int L,
                                const void* env, int q, void* out,
                                void* stream) {
  if (n_programs <= 0 || q <= 0) return 0;
  if (L < 1 || L > REPRO_VM_MAX_L)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = (q + 32 * kFastLanes - 1) / (32 * kFastLanes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  VmLayout lay = vm_layout(L, 32 * warps * kFastLanes);
  while (warps > 1 &&
         static_cast<size_t>(lay.total) * 4 > REPRO_MAX_DYN_SMEM) {
    --warps;
    lay = vm_layout(L, 32 * warps * kFastLanes);
  }
  if (fast_attr() != cudaSuccess) return static_cast<int>(fast_attr());
  policy_vm_kernel<kFastLanes, true>
      <<<n_programs, 32 * warps, static_cast<size_t>(lay.total) * 4,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(tables), L, lay,
          static_cast<const int*>(env), q, static_cast<int*>(out), nullptr);
  return static_cast<int>(cudaGetLastError());
}
