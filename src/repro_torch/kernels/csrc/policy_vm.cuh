// The MC-policy VM, shared by the batch policy_vm kernel and the slot_scan
// kernel (which evaluates it on every scheduling decision of a policy
// group).
//
// Semantics are those of src/repro/core/smcprog.py eval_table_rows: a
// packed table is a header row (n_ops, score_reg, boost_reg,
// mitigate_reg) followed by L rows (op, a, b, imm). Row i writes value
// i; operands are clipped to [0, L) and read zero from rows not yet
// written; a load opcode reads the environment, every ALU opcode its
// candidate, any other opcode the immediate. ADD/SUB/MUL wrap in int32.
// All opcodes are lane-wise, so each queue lane is evaluated on its own.
//
// A table is decoded once per launch (vm_decode, one warp, in the block's
// prologue) into a program that runs on every evaluation; the same rules
// are written in plain PyTorch in kernels/ref.py (decode_table,
// eval_decoded), which the CPU tests hold against the JAX VM:
// - a lane's values live in slots: the N_LOADS environment loads, a slot
//   that reads zero, then one slot per table row. A load row is no
//   instruction: a reference to it reads its environment slot. A
//   constant row (OP_CONST and any opcode outside the set) is written
//   once, before the first evaluation;
// - an operand is clipped to [0, L) and one at or past its own row reads
//   the zero slot; NOT becomes EQ with the zero slot; SELECT's third
//   operand is its clipped imm;
// - the header's score register resolves to a slot after the clip; a
//   negative boost or mitigate register to the zero slot, tested before
//   the clip;
// - only ALU rows that a header register reaches (through a, b and
//   SELECT's imm) run, in table order, one int4 each: (op | dst << 5,
//   a, b, c), every slot premultiplied by the column count.
// Values are interleaved across the evaluating lanes: slot s of column c
// lies at s * cols + c, so a warp's accesses to one slot are consecutive
// words (no bank conflict in shared memory, coalesced in global scratch).
#pragma once

#include "common.cuh"

#define REPRO_N_LOADS 12
// the longest table the kernels' fast instantiations take (longer
// tables take their wide instantiations)
#define REPRO_VM_MAX_L 256

namespace repro_vm {
enum : int {
  kOpAge = 1, kOpParaRand = 12,
  kOpAdd = 16, kOpSub, kOpMul, kOpMin, kOpMax, kOpAnd, kOpOr, kOpNot,
  kOpEq, kOpLt, kOpGe, kOpSelect
};
constexpr int kZero = REPRO_N_LOADS;      // the slot that reads zero
constexpr int kRow0 = REPRO_N_LOADS + 1;  // the slot of table row 0
constexpr int kDstShift = 5;              // opcodes are below 32
// header ints at the start of a decoded region
enum : int { kHExec, kHConst, kHScore, kHBoost, kHMit, kHEnv, kHCols, kHVals,
             kHProg, kHInts = 12 };
}  // namespace repro_vm

// Where a decoded table lives in a region of ints (shared memory or
// global scratch): the header, the program (one int4 a row: the raw rows
// while decoding, the program in their last n_exec rows after), the
// constants (slot, value), the live rows (a bit each) and the values of
// `cols` lanes. Offsets and the total are multiples of 4 ints, so that a
// region may follow another.
struct VmLayout {
  int o_prog, o_const, o_live, o_vals, total;
};

// vm_layout's offsets for L rows and cols columns; total < 0 when the
// region or a premultiplied slot cannot be indexed with an int.
__host__ __device__ inline VmLayout vm_layout(int L, int cols) {
  using namespace repro_vm;
  VmLayout v{};
  const long long l = L;
  const long long o_prog = kHInts;
  const long long o_const = o_prog + 4 * l;
  const long long o_live = o_const + 2 * l;
  const long long o_vals = (o_live + (l + 31) / 32 + 3) & ~3LL;
  const long long n_vals = (kRow0 + l) * cols;
  const long long total = (o_vals + n_vals + 3) & ~3LL;
  if (total > 0x7fffffffLL || (n_vals << kDstShift) > 0x7fffffffLL) {
    v.total = -1;
    return v;
  }
  v.o_prog = static_cast<int>(o_prog);
  v.o_const = static_cast<int>(o_const);
  v.o_live = static_cast<int>(o_live);
  v.o_vals = static_cast<int>(o_vals);
  v.total = static_cast<int>(total);
  return v;
}

// The raw rows of a packed table (L + 1 rows of 4 ints, 16-byte aligned)
// into the region's program area, by threads [tid, ..., stride).
__device__ __forceinline__ void vm_stage(const int* table, int L, int* vm,
                                         const VmLayout& lay, int tid,
                                         int stride) {
  const int4* src = reinterpret_cast<const int4*>(table) + 1;
  int4* rows = reinterpret_cast<int4*>(vm + lay.o_prog);
  for (int i = tid; i < L; i += stride) rows[i] = __ldg(src + i);
}

// The slot of raw row r: its environment load, or its own.
__device__ __forceinline__ int vm_row_slot(const int4* rows, int r) {
  using namespace repro_vm;
  const int op = reinterpret_cast<const int*>(rows + r)[0];
  return op >= kOpAge && op <= kOpParaRand ? op - kOpAge : kRow0 + r;
}

// Decode the staged table (header row at `table`, in global memory) by
// one full warp, in one pass over 32-row chunks from the last down. A
// chunk's live rows mark the rows they read inside it (a warp OR, repeated
// until nothing changes) and below it (atomics, read back with volatile
// loads, which in global scratch do not stop at the L1 cache). A live ALU
// row with k live ALU rows above it is written at raw row L - 1 - k, at or
// above its own, so every row still to be read (below, or in this chunk
// before the warp writes) is intact; the program is the last n_exec rows,
// in table order.
static __device__ __noinline__ void vm_decode(const int* table, int L,
                                              int cols, int* vm,
                                              VmLayout lay) {
  using namespace repro_vm;
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int4* rows = reinterpret_cast<int4*>(vm + lay.o_prog);
  int2* consts = reinterpret_cast<int2*>(vm + lay.o_const);
  unsigned* live = reinterpret_cast<unsigned*>(vm + lay.o_live);
  const int nw = (L + 31) >> 5;
  const int h_score = table[1], h_boost = table[2], h_mit = table[3];
  // the header's slots, before any raw row is overwritten
  const int score = vm_row_slot(rows, clampi(h_score, 0, L - 1));
  const int boost =
      h_boost >= 0 ? vm_row_slot(rows, clampi(h_boost, 0, L - 1)) : kZero;
  const int mit =
      h_mit >= 0 ? vm_row_slot(rows, clampi(h_mit, 0, L - 1)) : kZero;
  for (int w = lane; w < nw; w += 32) live[w] = 0u;
  __syncwarp();
  if (lane == 0) {
    const int r = clampi(h_score, 0, L - 1);
    live[r >> 5] |= 1u << (r & 31);
    if (h_boost >= 0) {
      const int rb = clampi(h_boost, 0, L - 1);
      live[rb >> 5] |= 1u << (rb & 31);
    }
    if (h_mit >= 0) {
      const int rm = clampi(h_mit, 0, L - 1);
      live[rm >> 5] |= 1u << (rm & 31);
    }
  }
  __syncwarp();
  int n_exec = 0, n_const = 0;
  unsigned env = 0u;
  const unsigned above = ~((2u << lane) - 1u);
  for (int c = nw - 1; c >= 0; --c) {
    const int i = c * 32 + lane;
    const bool valid = i < L;
    const int4 r = valid ? rows[i] : make_int4(0, 0, 0, 0);
    const bool load = r.x >= kOpAge && r.x <= kOpParaRand;
    const bool alu = valid && r.x >= kOpAdd && r.x <= kOpSelect;
    const int ra = clampi(r.y, 0, L - 1);
    const int rb = clampi(r.z, 0, L - 1);
    const int rc = clampi(r.w, 0, L - 1);
    const bool ua = alu && ra < i;
    const bool ub = alu && r.x != kOpNot && rb < i;
    const bool uc = alu && r.x == kOpSelect && rc < i;
    const int base = c * 32;
    unsigned dep = 0u;
    if (ua && ra >= base) dep |= 1u << (ra - base);
    if (ub && rb >= base) dep |= 1u << (rb - base);
    if (uc && rc >= base) dep |= 1u << (rc - base);
    unsigned w = *reinterpret_cast<volatile unsigned*>(live + c);
    for (;;) {
      const unsigned add =
          __reduce_or_sync(kAll, ((w >> lane) & 1u) ? dep : 0u);
      if ((w | add) == w) break;
      w |= add;
    }
    const bool lv = valid && ((w >> lane) & 1u);
    if (lv) {
      if (ua && ra < base) atomicOr(live + (ra >> 5), 1u << (ra & 31));
      if (ub && rb < base) atomicOr(live + (rb >> 5), 1u << (rb & 31));
      if (uc && rc < base) atomicOr(live + (rc >> 5), 1u << (rc & 31));
    }
    const bool ex = lv && alu;
    const bool cn = lv && !alu && !load;
    int4 d = make_int4(0, 0, 0, 0);
    if (ex) {
      const int sa = ua ? vm_row_slot(rows, ra) : kZero;
      const int sb = ub ? vm_row_slot(rows, rb) : kZero;
      const int sc = uc ? vm_row_slot(rows, rc) : kZero;
      env |= (sa < kZero ? 1u << sa : 0u) | (sb < kZero ? 1u << sb : 0u) |
             (sc < kZero ? 1u << sc : 0u);
      const int op = r.x == kOpNot ? kOpEq : r.x;
      d = make_int4(op | ((kRow0 + i) * cols) << kDstShift, sa * cols,
                    sb * cols, sc * cols);
    }
    const unsigned em = __ballot_sync(kAll, ex);
    const unsigned cm = __ballot_sync(kAll, cn);
    __syncwarp();   // every lane read its rows before any is overwritten
    if (ex) rows[L - 1 - n_exec - __popc(em & above)] = d;
    if (cn) consts[n_const + __popc(cm & above)] = make_int2(
        (kRow0 + i) * cols, r.w);
    n_exec += __popc(em);
    n_const += __popc(cm);
    __syncwarp();
  }
  env = __reduce_or_sync(kAll, env);
  if (lane == 0) {
    env |= (score < kZero ? 1u << score : 0u) |
           (boost < kZero ? 1u << boost : 0u) |
           (mit < kZero ? 1u << mit : 0u);
    vm[kHExec] = n_exec;
    vm[kHConst] = n_const;
    vm[kHScore] = score * cols;
    vm[kHBoost] = boost * cols;
    vm[kHMit] = mit * cols;
    vm[kHEnv] = static_cast<int>(env);
    vm[kHCols] = cols;
    vm[kHVals] = lay.o_vals;
    vm[kHProg] = lay.o_prog + 4 * (L - n_exec);
  }
  __syncwarp();
}

// Stage and decode a table by one warp (the warp that runs it), then
// write the zero slot, the constants and zero environment slots
// (`zero_env`, a slot mask) into columns lane and, if two, lane + 32.
__device__ __forceinline__ void vm_prepare_warp(const int* table, int L,
                                                int cols, int* vm,
                                                const VmLayout& lay,
                                                bool two, unsigned zero_env) {
  const int lane = threadIdx.x & 31;
  vm_stage(table, L, vm, lay, lane, 32);
  __syncwarp();
  vm_decode(table, L, cols, vm, lay);
  int* vals = vm + lay.o_vals;
  const int2* consts = reinterpret_cast<const int2*>(vm + lay.o_const);
  const int n_const = vm[repro_vm::kHConst];
  for (int h = 0; h < (two ? 2 : 1); ++h) {
    const int col = lane + 32 * h;
    vals[repro_vm::kZero * cols + col] = 0;
    for (int s = 0; s < REPRO_N_LOADS; ++s)
      if ((zero_env >> s) & 1u) vals[s * cols + col] = 0;
    for (int k = 0; k < n_const; ++k) vals[consts[k].x + col] = consts[k].y;
  }
}

// What an evaluation reads of the decoded header, kept in registers by a
// caller that evaluates many times.
struct VmHot {
  int n_exec, prog, vals, cols, score, boost, mit;
  unsigned env;
};

__device__ __forceinline__ VmHot vm_hot(const int* vm) {
  using namespace repro_vm;
  return {vm[kHExec], vm[kHProg], vm[kHVals], vm[kHCols], vm[kHScore],
          vm[kHBoost], vm[kHMit], static_cast<unsigned>(vm[kHEnv])};
}

// Run the decoded program (n rows at prog) over N columns col[0..N)
// (interleaved chains: each row loads its operands for every column
// before any result).
template <int N>
__device__ __forceinline__ void vm_run(const int4* prog, int n, int* vals,
                                       const int (&col)[N]) {
  using namespace repro_vm;
  int4 next = n > 0 ? prog[0] : make_int4(0, 0, 0, 0);
  for (int r = 0; r < n; ++r) {
    const int4 d = next;   // the next row loads beside this one's chain
    if (r + 1 < n) next = prog[r + 1];
    int a[N], b[N], v[N];
#pragma unroll
    for (int h = 0; h < N; ++h) {
      a[h] = vals[d.y + col[h]];
      b[h] = vals[d.z + col[h]];
    }
    switch (d.x & ((1 << kDstShift) - 1)) {
#define REPRO_VM_OP(code, expr)                    \
  case code:                                       \
    _Pragma("unroll") for (int h = 0; h < N; ++h) { \
      const int x = a[h], y = b[h];                \
      v[h] = (expr);                               \
    }                                              \
    break;
      REPRO_VM_OP(kOpAdd, wadd(x, y))
      REPRO_VM_OP(kOpSub, wsub(x, y))
      REPRO_VM_OP(kOpMul, wmul(x, y))
      REPRO_VM_OP(kOpMin, x < y ? x : y)
      REPRO_VM_OP(kOpMax, x > y ? x : y)
      REPRO_VM_OP(kOpAnd, x & y)
      REPRO_VM_OP(kOpOr, x | y)
      REPRO_VM_OP(kOpEq, x == y ? 1 : 0)
      REPRO_VM_OP(kOpLt, x < y ? 1 : 0)
      REPRO_VM_OP(kOpGe, x >= y ? 1 : 0)
      REPRO_VM_OP(kOpSelect, x != 0 ? y : vals[d.w + col[h]])
#undef REPRO_VM_OP
      default:   // decode writes no other opcode
#pragma unroll
        for (int h = 0; h < N; ++h) v[h] = 0;
        break;
    }
    const int dst = d.x >> kDstShift;
#pragma unroll
    for (int h = 0; h < N; ++h) vals[dst + col[h]] = v[h];
  }
}
