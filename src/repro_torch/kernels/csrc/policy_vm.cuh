// The MC-policy VM body, shared by the batch policy_vm kernel and the
// slot_scan kernel (which calls it on every scheduling decision).
//
// Semantics are those of src/repro/core/smcprog.py eval_table_rows: a
// packed table is a header row (n_ops, score_reg, boost_reg,
// mitigate_reg) followed by L rows (op, a, b, imm). Row i writes value
// i; operands are clipped to [0, L) and read zero from rows not yet
// written; a load opcode reads the environment, every ALU opcode its
// candidate, any other opcode the immediate. ADD/SUB/MUL wrap in int32.
// All opcodes are lane-wise, so one lane of the Q-wide environment is
// evaluated on its own.
#pragma once

#include "common.cuh"

#define REPRO_N_LOADS 12
// the longest table whose VM scratch is a local array (longer tables
// take the kernels' wide instantiations)
#define REPRO_VM_MAX_L 256

namespace repro_vm {
enum : int {
  kOpAge = 1, kOpParaRand = 12,
  kOpAdd = 16, kOpSub, kOpMul, kOpMin, kOpMax, kOpAnd, kOpOr, kOpNot,
  kOpEq, kOpLt, kOpGe, kOpSelect
};
}  // namespace repro_vm

// table: (L + 1) * 4 ints; env: REPRO_N_LOADS ints of this lane;
// vals: scratch of L ints, value i at vals[i * vstride] (a local array for
// L <= REPRO_VM_MAX_L; shared or global memory interleaved across threads
// for longer tables). Writes the lane's score, boost and mitigate.
__device__ __forceinline__ void policy_vm_lane(const int* table, int L,
                                               const int* env, int* vals,
                                               int* score, int* boost,
                                               int* mitigate,
                                               int vstride = 1) {
  using namespace repro_vm;
  for (int i = 0; i < L; ++i) vals[i * vstride] = 0;
  for (int i = 0; i < L; ++i) {
    const int* r = table + 4 * (i + 1);
    const int op = r[0];
    const int imm = r[3];
    const int va = vals[clampi(r[1], 0, L - 1) * vstride];
    const int vb = vals[clampi(r[2], 0, L - 1) * vstride];
    const int vc = vals[clampi(imm, 0, L - 1) * vstride];
    int v = imm;
    if (op >= kOpAge && op <= kOpParaRand) v = env[op - kOpAge];
    switch (op) {
      case kOpAdd: v = wadd(va, vb); break;
      case kOpSub: v = wsub(va, vb); break;
      case kOpMul: v = wmul(va, vb); break;
      case kOpMin: v = va < vb ? va : vb; break;
      case kOpMax: v = va > vb ? va : vb; break;
      case kOpAnd: v = va & vb; break;
      case kOpOr: v = va | vb; break;
      case kOpNot: v = va == 0 ? 1 : 0; break;
      case kOpEq: v = va == vb ? 1 : 0; break;
      case kOpLt: v = va < vb ? 1 : 0; break;
      case kOpGe: v = va >= vb ? 1 : 0; break;
      case kOpSelect: v = va != 0 ? vb : vc; break;
      default: break;
    }
    vals[i * vstride] = v;
  }
  const int hb = table[2];
  const int hm = table[3];
  *score = vals[clampi(table[1], 0, L - 1) * vstride];
  *boost = hb >= 0 ? vals[clampi(hb, 0, L - 1) * vstride] : 0;
  *mitigate = hm >= 0 ? vals[clampi(hm, 0, L - 1) * vstride] : 0;
}
