// The emulator's slot scan: one warp runs one trace row of a batch group
// through the whole slot budget.
//
// Replaces the lax.scan over _make_slot_body in
// src/repro/core/emulator.py (_run_core, the scan at line 531), which
// XLA runs as ~100 tiny ops per slot; as separate GPU launches that
// would be one launch per op per slot.
//
// What bounds it on the H100: each slot depends on the one before (the
// MC counter, the DRAM frontier, the bank state), so a row is a serial
// chain of `slots` steps. Bytes (the five trace arrays, the weak flags,
// the two tag arrays) and total operations are far below the card's
// rates; the floor is slots x the latency of one step, whatever the
// batch. A warp issues in order, so a step costs the length of its
// dependent chain plus one cycle per instruction, and a branch about as
// much as a shared-memory load: the design keeps all three short.
//
// Two instantiations, which the wrapper picks from the group's shape
// alone: the fast one (slot_scan_kernel, described here) for a queue of
// up to SCAN_MAX_Q lanes, up to SCAN_MAX_BANKS banks and a policy table
// of up to REPRO_VM_MAX_L rows, which covers every main-path group; and
// the wide one (slot_scan_wide_kernel, at the end of this file) for every
// other shape the reference engine takes.
//
// - One block of one warp per row. Queue lane q lives in the registers
//   of lane q % 32 (Q <= 64: a lane holds two): the request's index,
//   t_issue, bank, row and kind / weak flags, copied at issue, and its
//   bank's state (open row, ready, ACT time), kept current by every
//   service. The free lanes are a 64-bit mask kept alike in every lane;
//   the first free lane is its lowest set bit, as the strict scan picks
//   it.
// - Scalar state (issue pointer, MC counter, DRAM frontier, counters)
//   is computed alike in every lane, so nothing is broadcast; the picked
//   request reaches every lane by shuffles from its owner.
// - The earliest issue time m over the queue is kept current (a min at
//   issue, one min-reduction after serving the lane that held it): a
//   slot serves iff m <= cutoff, so an idle slot costs no warp traffic.
// - The scheduling decision runs across the warp: row hits and the
//   lanes holding the minimum by ballot (ties to the first lane, as the
//   strict '<' scans), a min-reduction only where several lanes hit.
//   With a policy table the warp decodes it once, in the prologue
//   (policy_vm.cuh), keeps the decoded header in registers, and every
//   thread evaluates its lanes at each decision (qlo and qhi as two
//   interleaved chains where Q > 32), all at once.
// - The issue frontier is not rerun while it is stuck: after it failed
//   at ptr, it would fail again until a service writes the t_resp it
//   waited on or frees a lane. Its next request sits in registers, and
//   an advance has one branch, its exit.
// - The tick conversions (t * kFP // den, and that // tREFI) of every
//   lane's issue time are computed beside the decision's warp traffic,
//   the DRAM frontier's is kept with it; the MC counter's is computed
//   only when it is later than the picked request. Divisions by the
//   group's fixed divisors use a precomputed multiplier, without a
//   branch.
// - Rarely taken paths (staging, a key at BIG) are out of line or behind
//   one branch, so that the slot loop stays compact. Policy and legacy
//   groups run two instantiations of the kernel (kPolicy): the legacy
//   loop holds no VM code, the policy loop the VM inline.
// - Row state on chip, in shared memory: the bank state, a stage of the
//   trace ahead of the issue pointer (filled by the warp with coalesced
//   loads, kStage / 2 entries at a time) and a ring of the t_resp of the
//   last kRing issued requests; with a policy table, its decoded program
//   and the VM's values and environment, [slot][lane], in dynamic shared
//   memory sized at launch from the table (legacy groups have none).
//   t_issue / t_resp are written through to global memory as they are
//   set; the outputs are those global arrays.
// - A row stops once it has drained (condition (c) below), so the
//   surplus slots of a group's budget cost nothing.
//
// The Bloom probe is not in the loop: its key depends only on the
// request, so the wrapper probes every request once (bloom_probe kernel)
// and this kernel reads one int8 flag per request.
//
// Fault injection (core/faults.py apply_slot, which the reference runs
// inside the same slot body) is a third compile-time flag of the fast
// instantiation's row body (kFaults) and a kernel of its own
// (slot_scan_faults_kernel, whose parameters alone carry FaultParams and
// the fault outputs), so that the fault-free kernels compile as they did.
// The engine runs it for a group with a fault model and for a policy
// group whose table loads para_rand (a draw under seed 0 without a fault
// model). In it:
// - the per-bank aggressor counters sit in shared memory beside the bank
//   state (sm_hct, <= 64 banks); an all-bank REF (refs_due > 0 on a
//   served slot) resets them, two stores a lane;
// - the retention draw depends only on (bank, row), so it is hashed per
//   request when the stage is filled (stage_weak, 32 lanes wide, off the
//   slot chain), as the Bloom flag is probed ahead; a READ then flips
//   when its flag is set and its service tick lies retention_ticks past
//   the last tREFI boundary;
// - the hammer draws are made only on a crossing activation: every lane
//   derives the slot key, and lanes 0 and 1 draw for row - 1 and row + 1
//   at once;
// - events go straight to the global victim log (they are rare), in the
//   reference's order (hammer row - 1, hammer row + 1, retention); the
//   counts go on past its end;
// - the policy VM's hammer_ct loads the lane's bank counter and
//   para_rand is drawn per lane when the decoded program loads it, under
//   the per-decision key fold_in(kp, dram_now), computed once; the picked
//   lane's mitigate resets its bank's counter and adds mit_ticks to the
//   bank's ready time.
// The wide instantiation does the same at run time, with its counters in
// its row region.
//
// The window entry (kStream, slot_scan_window_kernel and the wide one's
// window kernel) runs one stream window (core/emulator.py run_stream; the
// reference's _stream_step_core after its shift): the row's state comes in
// from global memory and goes back out (WindowIO), the trace arrays are the
// window's, t_issue / t_resp are read and written in place, and every slot
// runs under the freeze gate (f). Nothing on chip carries between windows:
// the prologue rebuilds the ring from t_resp (a), the stage from ptr, the
// queue lanes (index, issue time, bank, row, flags, their banks' state),
// the free mask and m from the queue; the stuck test starts clear. The
// epilogue stores the bank state, the queue, the scalars and the fault
// carry (counters, vptr and the counts; the victim log is written in place
// as events happen, and holds no indices, so it rides the shift as is).
// There is no trailing pass and no statistics pass: the host accumulates
// the emitted t_issue / t_resp.
//
// Exactness conditions (held by tests/test_torch_cuda.py's slot-scan
// cases and by chip_smoke.py phases 4 and 7 against the plain engine):
//
// (a) The ring. t_resp[i] is read only by the issue frontier, at
//     i = j - window and i = j - dep for the request j = ptr being
//     issued, so always i < ptr. The ring slot i % kRing belongs to the
//     latest issued request of that residue: the kRing requests
//     [ptr - kRing, ptr) own distinct slots, written at issue (BIG for a
//     real request, t_new for a NOP) and at service. The window read
//     (1 <= window <= Q <= 64 < kRing, or BIG for a window below 1: the
//     reference's initial value of a request not yet issued) is always
//     in the ring; a dependence read more than kRing back goes to global
//     memory, which holds every value set outside the trailing pass
//     (written through). The wrapper refuses a window above Q.
//     A request not yet served lies at index >= ptr - window: request
//     i + window issued only after win_known saw t_resp[i] < BIG
//     (emulator.py _issue_frontier, line 280), and issue is in order.
//     With window <= SCAN_MAX_Q < kRing a service therefore always lands
//     in the ring; the guarded ring write in the service keeps the
//     kernel exact even where it would not. (The wide instantiation
//     sizes its ring from the window: see there.)
// (b) The trailing pass. The reference keeps only the t_issue of its
//     trailing frontier pass: the t_resp of NOPs it resolves is seen by
//     later advances of the same pass and never stored. Here those go to
//     the ring alone (never to global memory), and the pass moves the
//     pointer by at most 8 < kRing, so every read of them hits the ring.
// (c) When a row stops. Only when ptr == n and no queue lane is valid:
//     then the frontier returns at once (j < n fails) and the slot has
//     nothing visible and nothing valid (no idle hop), so every later
//     slot leaves the state as it is. The trailing pass would do
//     nothing and is skipped, and the closing reduction reads the same
//     arrays the reference would, NOP entries included.
// (d) Bit-exactness as in the reference: int32 wraparound via
//     common.cuh, numpy floor division and modulo (FloorDiv below is
//     exact for every int32 dividend and divisor >= 1; the wrapper
//     refuses a tREFI or bank count below 1), the host-rounded
//     scale_num, argmin and first-free ties to the first lane. Keys at or
//     above BIG (issue times past 2^30) take the general argmin.
// (f) The window's freeze gate. A window slot runs only while final or ptr
//     <= n - 4, evaluated at the start of the slot (the reference ANDs it
//     into every frontier advance, the service and the idle hop). A frozen
//     slot is the identity, and ptr, on which the gate depends, cannot
//     move while frozen, so the row stops at its first frozen slot as it
//     stops once drained (c). In a window ring entries below 0 are never
//     read: the window's virtual halo holds t_resp -1, whose t_resp + 1 = 0
//     is the out-of-range default, at indices >= 0.
// (e) The fault draws as in the reference: threefry2x32 in uint32
//     (threefry.cuh: the adds wrap, rotations are funnel shifts), each
//     data word the uint32 pattern of its int32 (row - 1 = -1 folds in
//     0xFFFFFFFF); the stream keys kh, kw, kp computed on the host
//     (core/threefry.py) and passed as int32 bit patterns; t_start %
//     tREFI by FloorDiv; the events logged in apply_slot's order, at the
//     log index vptr while vptr < victim_slots, vptr counting every flip.
#include <cuda_runtime.h>

#include "common.cuh"
#include "policy_vm.cuh"
#include "threefry.cuh"

#define SCAN_MAX_Q 64
#define SCAN_MAX_BANKS 64
#define SCAN_RESP_RING 1024
#define SCAN_STAGE 512

namespace {

constexpr int kFP = 4096;
constexpr int kWrite = 1;
constexpr int kRcCopy = 2;
constexpr int kRcInit = 3;
constexpr int kNop = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = SCAN_RESP_RING;   // power of two, > SCAN_MAX_Q + 8
constexpr int kStage = SCAN_STAGE;      // power of two, >= 2 * 8
// key of a lane at or past Q: above every key a real lane can hold, so
// it never wins a tie against one
constexpr int kKeyPast = 0x7fffffff;
// a request's flags, from its kind and (with weak flags) weak row; with a
// retention model, whether its row is a weak cell
constexpr int kFWrite = 1, kFRc = 2, kFNop = 4, kFWeak0 = 8, kFWeakCell = 16;

// Host parameter block, in this order (see slot_scan.py): the scan's
// scalars, then the fault path's. The fault-free kernels take only the
// first struct, so that their parameters, and the code compiled for them,
// are as they were before the fault path existed.
struct ScanParams {
  int batch, n, window, q, slots, n_banks, n_rows;
  int scale_num, mc_lat, mc_issue_ts, nots, frfcfs, table_len, use_weak;
  int tRCD, tRCD_reduced, tCL, tRP, tRAS, tWR, tBL, tRFC, tREFI, tRC_CLONE;
};
// the fault path (faults.py): victim_slots 0 without a fault model
struct FaultParams {
  int faults, hammer_threshold, hammer_flip_fp, weak_fp, retention_ticks;
  int victim_slots, mit_ticks;
  int kh0, kh1, kw0, kw1, kp0, kp1;   // threefry stream keys
};
constexpr int kNumParams =
    (sizeof(ScanParams) + sizeof(FaultParams)) / sizeof(int);
// A stream window's row state in global memory, read in the prologue and
// written back in the epilogue (kStream): the queue [batch][q] (request
// indices, -1 free), the scalars [batch][kWinScalars] (ptr, mc_release,
// dram_now, hits, served, smc, last_bank, bus_busy, refs_done), the bank
// state [batch][3][n_banks] (open row, ready, ACT tick) and, with a fault
// model, the bank counters [batch][n_banks]; final lifts the freeze.
struct WindowIO {
  int* queue;
  int* scal;
  int* bst;
  int* hct;
  int final;
};
constexpr int kWinScalars = 9;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Floor division by a fixed divisor d >= 1, without a branch: numpy's
// a // d for every int32 a. With l = ceil(log2 d), m = ceil(2^(31 + l) /
// d) < 2^32 and (u * m) >> (31 + l) == u // d for 0 <= u < 2^31, because
// u * (m * d - 2^(31 + l)) < 2^31 * d <= 2^(31 + l). A negative a maps to
// ~a >= 0: a // d == ~(~a // d).
struct FloorDiv {
  int d;
  unsigned mul;
  int shift;

  __device__ explicit FloorDiv(int den) : d(den) {
    shift = 31 + (den > 1 ? 32 - __clz(den - 1) : 0);
    mul = static_cast<unsigned>(((1ull << shift) + den - 1) / den);
  }
  __device__ __forceinline__ int div(int a) const {
    const unsigned sign = static_cast<unsigned>(a >> 31);
    const unsigned u = static_cast<unsigned>(a) ^ sign;
    const unsigned q = static_cast<unsigned>(
        (static_cast<unsigned long long>(u) * mul) >> shift);
    return static_cast<int>(q ^ sign);
  }
  __device__ __forceinline__ int mod(int a) const {
    return wsub(a, wmul(div(a), d));
  }
};

// Exact a * num // den without int32 overflow for the engine's ranges.
__device__ __forceinline__ int mul_div(int a, int num, const FloorDiv& den) {
  const int q = den.div(a);
  const int r = wsub(a, wmul(q, den.d));
  return wadd(wmul(q, num), den.div(wmul(r, num)));
}

// a * num // kFP, kFP = 2^12: an arithmetic shift is the floor division
__device__ __forceinline__ int mul_div_fp(int a, int num) {
  return wadd(wmul(a >> 12, num), wmul(a & (kFP - 1), num) >> 12);
}

// One queue lane's request, copied at issue, and the state of its bank,
// kept current by every service.
struct Lane {
  int idx, t, bank, row, flags;
  int open, ready, act;
};

__device__ __forceinline__ Lane select_lane(bool c, const Lane& a,
                                            const Lane& b) {
  return {c ? a.idx : b.idx,     c ? a.t : b.t,
          c ? a.bank : b.bank,   c ? a.row : b.row,
          c ? a.flags : b.flags, c ? a.open : b.open,
          c ? a.ready : b.ready, c ? a.act : b.act};
}

// The next request the frontier would issue, read from the stage.
struct Next {
  int flags, delta, dep, bank, row;
};

__device__ __forceinline__ int request_flags(int kind, int weak0) {
  return (kind == kWrite ? kFWrite : 0) |
         (kind == kRcCopy || kind == kRcInit ? kFRc : 0) |
         (kind == kNop ? kFNop : 0) | (weak0 ? kFWeak0 : 0);
}

// One DRAM service (dram.py service_request) of a request with flags fl
// to row rw, starting at tick now with refs_due refreshes owed, on a bank
// whose row o_row is open, ready at b_ready and activated at b_act; the
// data bus is busy until bus_busy. Both instantiations run this.
struct Service {
  int t_done, bank_next, act_next, bus_next;
  bool hit;
};

__device__ __forceinline__ Service dram_service(const ScanParams& p, int now,
                                                int refs_due, int fl, int rw,
                                                int o_row, int b_ready,
                                                int b_act, int bus_busy) {
  const int trcd = (fl & kFWeak0) ? p.tRCD_reduced : p.tRCD;
  const int start = wadd(imax(now, b_ready), wmul(refs_due, p.tRFC));
  const bool is_rc = (fl & kFRc) != 0;
  const bool is_hit = o_row == rw && !is_rc;
  const bool is_closed = o_row < 0;
  const int pre_at = imax(start, wadd(b_act, p.tRAS));
  const int act_start = is_closed ? start : wadd(pre_at, p.tRP);
  const int col_start = is_hit ? start : wadd(act_start, trcd);
  const int data_start = imax(wadd(col_start, p.tCL), bus_busy);
  const int data_done = wadd(data_start, p.tBL);
  const int rc_done = wadd(act_start, p.tRC_CLONE);
  return {is_rc ? rc_done : data_done,
          is_rc ? rc_done
                : ((fl & kFWrite) ? wadd(data_done, p.tWR) : data_done),
          is_hit ? b_act : act_start, is_rc ? bus_busy : data_done, is_hit};
}

// The row's five statistics, after its last slot: exec_cycles is the
// latest response or issue over the real requests (the warp reads the
// written-through t_resp / t_issue), then the running counters.
__device__ __forceinline__ void write_stats(const int* kind, const int* tr,
                                            const int* ti, int n, int hits,
                                            int served, int dram_now,
                                            int smc, int* st) {
  const int lane = threadIdx.x;
  __syncwarp();
  int last_resp = 0, last_issue = 0;
#pragma unroll 4
  for (int i = lane; i < n; i += 32) {
    if (__ldg(kind + i) == kNop) continue;
    const int r = __ldcg(tr + i);
    if (r < REPRO_BIG) last_resp = imax(last_resp, r);
    last_issue = imax(last_issue, __ldcg(ti + i));
  }
  last_resp = __reduce_max_sync(kFull, last_resp);
  last_issue = __reduce_max_sync(kFull, last_issue);
  if (lane == 0) {
    st[0] = imax(last_resp, last_issue);
    st[1] = hits;
    st[2] = served;
    st[3] = dram_now;
    st[4] = smc;
  }
}

// The lane q < 64 of the lowest set bit of (hi << 32 | lo); some bit set.
__device__ __forceinline__ int first_set(unsigned lo, unsigned hi) {
  return lo != 0 ? __ffs(lo) - 1 : 31 + __ffs(hi);
}

// The first lane q < 64 whose flag is set (lane q % 32's lo flag for
// q < 32, hi flag for q >= 32); some flag must be set.
__device__ __forceinline__ int first_lane(bool lo, bool hi) {
  return first_set(__ballot_sync(kFull, lo), __ballot_sync(kFull, hi));
}

// The lowest lane q < 64 whose key (lane q % 32's klo for q < 32, khi
// for q >= 32) is the smallest: argmin with ties to the first lane.
__device__ __forceinline__ int warp_argmin(int klo, int khi) {
  const int m = __reduce_min_sync(kFull, imin(klo, khi));
  return first_lane(klo == m, khi == m);
}

// A row's on-chip state (one warp per block), one struct so that every
// access is one base address plus an offset.
struct RowState {
  int ring[kRing];                        // t_resp of the last kRing issued
  int flags[kStage], delta[kStage], dep[kStage], bank[kStage], row[kStage];
  int open[SCAN_MAX_BANKS], ready[SCAN_MAX_BANKS], act[SCAN_MAX_BANKS];
};
__shared__ RowState sm;
// A policy group's decoded table and VM values (policy_vm.cuh) are the
// fast kernel's dynamic shared memory, scan_vm[], laid out by
// vm_layout(table_len, scan_vm_cols(q)); none for legacy groups.

// The VM's columns in the fast instantiation: a thread's qlo and, where
// the queue has more than 32 lanes, its qhi.
__host__ __device__ inline int scan_vm_cols(int q) {
  return q > 32 ? 64 : 32;
}

// hammer_ct and para_rand, written once as zero: put_env loads them only
// on the fault path (ScanParams.faults); off it both load 0 in every
// instantiation and in the plain engine, and the engine runs a table
// that loads para_rand on the fault path
constexpr unsigned kEnvZero = (1u << 10) | (1u << 11);
// a lane's environment flags: is_write, row_hit, bank_busy
constexpr int kEnvWrite = 1, kEnvHit = 2, kEnvBusy = 4;

// Stages trace entries [from, to) with coalesced loads. Out of line, as
// are the other rarely taken paths, so that the slot loop stays compact
// in the instruction cache.
__device__ __noinline__ void stage_fill(const int* kind, const int* bank,
                                        const int* row, const int* delta,
                                        const int* dep, const int8_t* weak,
                                        int from, int to) {
  for (int i = from + static_cast<int>(threadIdx.x); i < to; i += 32) {
    const int s = i & (kStage - 1);
    sm.flags[s] = request_flags(__ldg(kind + i),
                               weak != nullptr && __ldg(weak + i) == 0);
    sm.bank[s] = __ldg(bank + i);
    sm.row[s] = __ldg(row + i);
    sm.delta[s] = __ldg(delta + i);
    sm.dep[s] = __ldg(dep + i);
  }
  __syncwarp();
}

// ---- the fault path (kFaults; faults.py)

// The per-bank aggressor counters of the fast instantiation's row.
__shared__ int sm_hct[SCAN_MAX_BANKS];

__device__ __forceinline__ uint2 key_of(int k0, int k1) {
  return make_uint2(static_cast<unsigned>(k0), static_cast<unsigned>(k1));
}

// Whether row rw of bank bk is a weak cell of the retention model: the
// top 16 bits of bits(fold_in(fold_in(kw, bank), row)) below weak_fp.
__device__ __forceinline__ bool weak_cell(uint2 kw, int weak_fp, int bk,
                                          int rw) {
  return tf_u16(tf_fold_in(tf_fold_in(kw, bk), rw)) < weak_fp;
}

// Marks the staged entries [from, to) whose row is a weak cell, after
// stage_fill, by the lanes that staged them.
__device__ __noinline__ void stage_weak(uint2 kw, int weak_fp, int from,
                                        int to) {
  for (int i = from + static_cast<int>(threadIdx.x); i < to; i += 32) {
    const int s = i & (kStage - 1);
    if (weak_cell(kw, weak_fp, sm.bank[s], sm.row[s]))
      sm.flags[s] |= kFWeakCell;
  }
  __syncwarp();
}

// A row's fault counters, alike in every lane: the flips (vptr, the next
// log index), hammer and retention flips, fired mitigations.
struct FaultState {
  int vptr, ham, ret, mits;
};

// faults.py apply_slot for one served slot, run by all 32 lanes: the
// request to bank bk, row rw (a READ if is_read, its row a weak cell if
// weak) served at tick now, a row hit if hit; refreshed: the service
// caught up on all-bank REFs; mit: the picked lane's mitigate. hct holds
// the row's n_hct bank counters, vlog its victim log [3][victim_slots] in
// global memory. Returns the extra ticks of a fired mitigation.
__device__ __forceinline__ int fault_slot(const ScanParams& p,
                                          const FaultParams& f, FaultState& fs,
                                          int* hct, int n_hct, int* vlog,
                                          int bk, int rw, bool is_read,
                                          bool weak, bool hit, int now,
                                          bool refreshed, bool mit,
                                          const FloorDiv& refi) {
  const int lane = threadIdx.x;
  if (refreshed) {   // the REF runs before this slot's own activation
    for (int i = lane; i < n_hct; i += 32) hct[i] = 0;
    __syncwarp();
  }
  unsigned ev = 0u;   // flips: bit 0 row - 1, bit 1 row + 1, bit 2 row
  if (f.hammer_threshold > 0) {
    const int cur = wadd(hct[bk], hit ? 0 : 1);
    const bool crossed = !hit && cur >= f.hammer_threshold;
    if (crossed) {   // lanes 0 and 1 draw for the two neighbours at once
      const uint2 kt =
          tf_fold_in(tf_fold_in(key_of(f.kh0, f.kh1), bk), now);
      const int vr = wadd(rw, (lane & 1) ? 1 : -1);
      const bool flip = vr >= 0 && vr < p.n_rows &&
                        tf_u16(tf_fold_in(kt, vr)) < f.hammer_flip_fp;
      ev = __ballot_sync(kFull, flip) & 3u;
    }
    hct[bk] = crossed || mit ? 0 : cur;
  }
  if (f.weak_fp > 0 && is_read && weak && refi.mod(now) >= f.retention_ticks)
    ev |= 4u;
  for (; ev != 0u; ev &= ev - 1u) {   // in apply_slot's order
    const int e = __ffs(ev) - 1;
    if (lane == 0 && fs.vptr < f.victim_slots) {
      const size_t V = static_cast<size_t>(f.victim_slots);
      vlog[fs.vptr] = bk;
      vlog[V + fs.vptr] = e == 2 ? rw : wadd(rw, e == 0 ? -1 : 1);
      vlog[2 * V + fs.vptr] = now;
    }
    fs.vptr = wadd(fs.vptr, 1);
    if (e == 2)
      ++fs.ret;
    else
      ++fs.ham;
  }
  fs.mits += mit ? 1 : 0;
  return mit ? f.mit_ticks : 0;
}

// The row's fault counters, by lane 0.
__device__ __forceinline__ void write_fault_stats(const FaultState& fs,
                                                  int* fst) {
  if (threadIdx.x == 0) {
    fst[0] = fs.vptr;
    fst[1] = fs.ham;
    fst[2] = fs.ret;
    fst[3] = fs.mits;
  }
}

// Writes the environment slots the decoded program reads (`mask`) of queue
// lane q into column col: its issue time t, bank, row and flags (kEnv*);
// with kFaults, its bank's aggressor counter hct and its para_rand draw
// under the decision's key kt. Both instantiations run this.
template <bool kFaults>
__device__ __forceinline__ void put_env(int* vals, int cols, int col,
                                       unsigned mask, int t, int bank,
                                       int row, int flags, int q,
                                       int min_vis, int wp, int last_bank,
                                       const FloorDiv& nbanks, int hct,
                                       uint2 kt) {
  int* v = vals + col;
  if (mask & (1u << 0)) v[0 * cols] = t;                          // age
  if (mask & (1u << 1)) v[1 * cols] = wsub(t, min_vis);           // age_rel
  if (mask & (1u << 2)) v[2 * cols] = (flags & kEnvHit) ? 1 : 0;  // row_hit
  if (mask & (1u << 3)) v[3 * cols] = bank;                       // bank
  if (mask & (1u << 4)) v[4 * cols] = row;                        // row
  if (mask & (1u << 5)) v[5 * cols] = flags & kEnvWrite;          // is_write
  if (mask & (1u << 6)) v[6 * cols] = (flags & kEnvBusy) ? 1 : 0; // bank_busy
  if (mask & (1u << 7))                                            // rr_dist
    v[7 * cols] = nbanks.mod(wsub(wsub(bank, last_bank), 1));
  if (mask & (1u << 8)) v[8 * cols] = q;                          // qslot
  if (mask & (1u << 9)) v[9 * cols] = wp;                   // write_pressure
  if (kFaults) {
    if (mask & (1u << 10)) v[10 * cols] = hct;                    // hammer_ct
    if (mask & (1u << 11))                                        // para_rand
      v[11 * cols] = tf_u16(tf_fold_in(tf_fold_in(kt, bank), row));
  }
}

__device__ __forceinline__ int env_flags(int flags, int open, int row,
                                         int ready, int dram_now) {
  return ((flags & kFWrite) ? kEnvWrite : 0) | (open == row ? kEnvHit : 0) |
         (ready > dram_now ? kEnvBusy : 0);
}

// The policy score and boost of a thread's lanes qlo (x, y) and, if two,
// qhi (z, w): the decoded program over their environments, as two
// interleaved chains; with kFaults also their mitigate outputs (mit), from
// their bank counters hct0 / hct1 and the decision's para key kt.
template <bool kFaults>
__device__ __forceinline__ int4 scan_policy(VmHot h, bool two, int t0,
                                            int bank0, int row0, int fl0,
                                            int t1, int bank1, int row1,
                                            int fl1, int min_vis, int wp,
                                            int last_bank, FloorDiv nbanks,
                                            int hct0, int hct1, uint2 kt,
                                            int2& mit) {
  extern __shared__ int4 scan_vm[];
  int* vm = reinterpret_cast<int*>(scan_vm);
  int* vals = vm + h.vals;
  const int4* prog = reinterpret_cast<const int4*>(vm + h.prog);
  const int lane = threadIdx.x;
  const int hs = h.score, hb = h.boost;
  put_env<kFaults>(vals, h.cols, lane, h.env, t0, bank0, row0, fl0, lane,
                   min_vis, wp, last_bank, nbanks, hct0, kt);
  if (!two) {
    const int col[1] = {lane};
    vm_run<1>(prog, h.n_exec, vals, col);
    if (kFaults) mit = make_int2(vals[h.mit + lane], 0);
    return make_int4(vals[hs + lane], vals[hb + lane], 0, 0);
  }
  put_env<kFaults>(vals, h.cols, lane + 32, h.env, t1, bank1, row1, fl1,
                   lane + 32, min_vis, wp, last_bank, nbanks, hct1, kt);
  const int col[2] = {lane, lane + 32};
  vm_run<2>(prog, h.n_exec, vals, col);
  if (kFaults) mit = make_int2(vals[h.mit + lane], vals[h.mit + lane + 32]);
  return make_int4(vals[hs + lane], vals[hb + lane], vals[hs + lane + 32],
                   vals[hb + lane + 32]);
}

// One row's slot scan, the body of the fast instantiation's kernels.
// kPolicy: a policy group (table_len > 0). Legacy groups run the other
// instantiation, whose slot loop holds no VM code at all, so that the
// VM's code cannot change how their loop is compiled (it did: with the
// VM in one shared loop, a change to the decode alone slowed the legacy
// groups; PERF.md §6). kFaults: the fault path (f.faults), for the same
// reason a flag of its own and a kernel of its own, whose parameters
// alone carry f, fstats [batch][4] and vlog [batch][3][victim_slots]
// (when f.victim_slots > 0): with them in the fault-free kernels' list,
// those compiled 5% slower (PERF.md §6).
// kStream: a stream window (WindowIO w; fstats then holds the fault
// counters in and out, and no statistics are written).
template <bool kPolicy, bool kFaults, bool kStream>
__device__ __forceinline__ void scan_row(
    const ScanParams& p, const FaultParams& f, const int* __restrict__ kinds,
    const int* __restrict__ banks, const int* __restrict__ rows,
    const int* __restrict__ deltas, const int* __restrict__ deps,
    const int8_t* __restrict__ weak_all, const int* __restrict__ tables,
    const int* __restrict__ costs, int* __restrict__ t_issue,
    int* __restrict__ t_resp, int* __restrict__ stats,
    int* __restrict__ fstats, int* __restrict__ vlog, const WindowIO& w) {
  extern __shared__ int4 scan_vm[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t off = static_cast<size_t>(b) * p.n;
  const int* kind = kinds + off;
  const int* bank = banks + off;
  const int* row = rows + off;
  const int* delta = deltas + off;
  const int* dep = deps + off;
  const int8_t* weak = p.use_weak ? weak_all + off : nullptr;
  int* ti = t_issue + off;
  int* tr = t_resp + off;
  const int n = p.n;
  const int Q = p.q;
  const int L = p.table_len;   // > 0 exactly when kPolicy

  VmHot vm_h{};   // the decoded header, for every decision
  if (kPolicy) {
    vm_prepare_warp(tables + static_cast<size_t>(b) * (L + 1) * 4, L,
                    scan_vm_cols(Q), reinterpret_cast<int*>(scan_vm),
                    vm_layout(L, scan_vm_cols(Q)), Q > 32, kEnvZero);
    vm_h = vm_hot(reinterpret_cast<const int*>(scan_vm));
  }
  for (int i = lane; i < SCAN_MAX_BANKS; i += 32) {
    sm.open[i] = -1;
    sm.ready[i] = 0;
    sm.act[i] = 0;
  }
  // the fault carry: a fault model (victim_slots > 0) keeps counters and a
  // log; without one the fault path only draws para_rand
  const bool carry = kFaults && f.victim_slots > 0;
  const bool retention = carry && f.weak_fp > 0;
  FaultState fs{0, 0, 0, 0};
  int* vl = carry ? vlog + static_cast<size_t>(b) * 3 * f.victim_slots
                  : nullptr;
  if (kFaults)
    for (int i = lane; i < SCAN_MAX_BANKS; i += 32) sm_hct[i] = 0;
  // a window's pointer: the stage, the ring and the frontier start there
  int ptr0 = 0;
  if constexpr (kStream) {
    const int nb = p.n_banks;
    const int* bs = w.bst + static_cast<size_t>(b) * 3 * nb;
    for (int i = lane; i < nb; i += 32) {
      sm.open[i] = bs[i];
      sm.ready[i] = bs[nb + i];
      sm.act[i] = bs[2 * nb + i];
      if (carry) sm_hct[i] = w.hct[static_cast<size_t>(b) * nb + i];
    }
    if (carry) {
      const int* fc = fstats + 4 * b;
      fs = FaultState{fc[0], fc[1], fc[2], fc[3]};
    }
    ptr0 = w.scal[kWinScalars * b];
    // (a): the ring holds the t_resp of the kRing requests below ptr
    for (int i = imax(ptr0 - kRing, 0) + lane; i < ptr0; i += 32)
      sm.ring[i & (kRing - 1)] = __ldcg(tr + i);
    __syncwarp();
  }
  const int counter_inc = costs[2 * b];
  const int smc_lat = costs[2 * b + 1];
  const int mc_issue = p.nots ? smc_lat : p.mc_issue_ts;
  const int vis_slack = p.nots ? smc_lat : 0;
  const FloorDiv den(imax(p.scale_num, 1));
  const FloorDiv refi(p.tREFI);
  const FloorDiv nbanks(p.n_banks);
  // 1 <= window <= Q <= 64 < kRing (the wrapper refuses a larger
  // window): t_resp[j - window] is in the ring (see (a)); a window below
  // 1 reads a request not yet issued, BIG
  const bool win_ok = p.window >= 1;

  // trace entries [hi - kStage, hi) are staged (those below 0 excepted);
  // the frontier never reads below ptr, so the next kStage / 2 entries
  // are staged once a pass could reach hi
  int hi = imin(n, ptr0 + kStage);
  stage_fill(kind, bank, row, delta, dep, weak, ptr0, hi);
  if (retention) stage_weak(key_of(f.kw0, f.kw1), f.weak_fp, ptr0, hi);
  auto next_at = [&](int j) -> Next {
    const int s = j & (kStage - 1);
    return {sm.flags[s], sm.delta[s], sm.dep[s], sm.bank[s], sm.row[s]};
  };

  const unsigned long long all_free =
      Q >= 64 ? ~0ull : (1ull << Q) - 1ull;
  unsigned long long free_mask = all_free;
  Lane qlo = {0, REPRO_BIG, 0, 0, 0, -1, 0, 0};
  Lane qhi = qlo;
  int m = kKeyPast;   // earliest t over the valid lanes
  int ptr = ptr0, prev_ti = 0;
  Next nx = next_at(ptr0);
  // the frontier failed at ptr and none of its inputs there (t_resp at
  // stuck_w and stuck_d, a free lane if stuck_full) has changed since:
  // it would fail again at once, so it is not run
  bool stuck = false, stuck_full = false;
  int stuck_w = -1, stuck_d = -1;
  int bus_busy = 0, refs_done = 0, mc_release = 0, dram_now = 0;
  int hits = 0, served = 0, smc = 0, last_bank = -1;
  if constexpr (kStream) {   // the window's scalars and queue lanes
    const int* sc = w.scal + kWinScalars * b;
    mc_release = sc[1];
    dram_now = sc[2];
    hits = sc[3];
    served = sc[4];
    smc = sc[5];
    last_bank = sc[6];
    bus_busy = sc[7];
    refs_done = sc[8];
    prev_ti = ptr > 0 ? __ldcg(ti + ptr - 1) : 0;
    const int* qrow = w.queue + static_cast<size_t>(b) * Q;
    const int i_lo = lane < Q ? qrow[lane] : -1;
    const int i_hi = lane + 32 < Q ? qrow[lane + 32] : -1;
    auto lane_of = [&](int idx, const Lane& none) -> Lane {
      if (idx < 0) return none;
      const int bk = __ldg(bank + idx), rw = __ldg(row + idx);
      int fl = request_flags(__ldg(kind + idx),
                             weak != nullptr && __ldg(weak + idx) == 0);
      if (retention && weak_cell(key_of(f.kw0, f.kw1), f.weak_fp, bk, rw))
        fl |= kFWeakCell;
      return {idx, __ldcg(ti + idx), bk, rw, fl,
              sm.open[bk], sm.ready[bk], sm.act[bk]};
    };
    qlo = lane_of(i_lo, qlo);
    qhi = lane_of(i_hi, qhi);
    const unsigned f_lo = __ballot_sync(kFull, lane < Q && i_lo < 0);
    const unsigned f_hi = __ballot_sync(kFull, lane + 32 < Q && i_hi < 0);
    free_mask = static_cast<unsigned long long>(f_hi) << 32 | f_lo;
    m = __reduce_min_sync(kFull, imin(i_lo >= 0 ? qlo.t : kKeyPast,
                                      i_hi >= 0 ? qhi.t : kKeyPast));
  }
  // dram_now // tREFI, kept with dram_now
  int dram_refs = refi.div(dram_now);

  // In-order issue of up to `upto` requests into free queue lanes
  // (emulator.py _issue_frontier). A disabled advance leaves every input
  // as it was, so the loop stops at the first one. The trailing pass
  // keeps NOP responses in the ring only, see (b).
  auto frontier = [&](int upto, bool trailing) {
    if (hi < n && ptr + upto > hi) {
      const int to = imin(n, hi + kStage / 2);
      stage_fill(kind, bank, row, delta, dep, weak, hi, to);
      if (retention) stage_weak(key_of(f.kw0, f.kw1), f.weak_fp, hi, to);
      hi = to;
      nx = next_at(ptr);
    }
    for (int u = 0; u < upto; ++u) {
      const int j = ptr;
      const int wj = wsub(j, p.window);
      const int wi = wj >= 0 ? imin(wj, n - 1) : -1;
      const int dj = wsub(j, nx.dep);
      const int di = nx.dep > 0 && dj >= 0 ? dj : -1;
      // both from the ring, but for a dependence more than kRing back
      // (di < ptr always)
      const int tw_ring = sm.ring[wi & (kRing - 1)];
      const int tw = win_ok ? tw_ring : REPRO_BIG;
      int td = sm.ring[di & (kRing - 1)];
      if (di >= 0 && di < ptr - kRing) td = __ldcg(tr + di);
      const bool is_nop = (nx.flags & kFNop) != 0;
      if (!(j < n && (wi < 0 || tw < REPRO_BIG) &&
            (di < 0 || td < REPRO_BIG) && (free_mask != 0 || is_nop))) {
        stuck = true;
        stuck_w = j < n ? wi : -1;
        stuck_d = j < n ? di : -1;
        stuck_full = j < n && free_mask == 0 && !is_nop;
        return;
      }
      const int t_new = imax(imax(wadd(prev_ti, nx.delta),
                                  wi >= 0 ? wadd(tw, 1) : 0),
                             di >= 0 ? wadd(td, 1) : 0);
      ti[j] = t_new;
      sm.ring[j & (kRing - 1)] = is_nop ? t_new : REPRO_BIG;
      if (is_nop && !trailing) tr[j] = t_new;
      // a real request takes the first free lane (a NOP's bank may be
      // anything: the index is masked, its state unused)
      const int slot = __ffsll(static_cast<long long>(free_mask)) - 1;
      const int bi = nx.bank & (SCAN_MAX_BANKS - 1);
      const Lane in = {j, t_new, nx.bank, nx.row, nx.flags,
                       sm.open[bi], sm.ready[bi], sm.act[bi]};
      const bool mine = !is_nop && lane == (slot & 31);
      qlo = select_lane(mine && slot < 32, in, qlo);
      qhi = select_lane(mine && slot >= 32, in, qhi);
      free_mask = is_nop ? free_mask : free_mask & (free_mask - 1);
      m = is_nop ? m : imin(m, t_new);
      prev_ti = t_new;
      ++ptr;
      nx = next_at(ptr);
    }
  };

  const bool real_lo = lane < Q;
  const bool real_hi = lane + 32 < Q;
  const int past_lo = real_lo ? REPRO_BIG : kKeyPast;
  const int past_hi = real_hi ? REPRO_BIG : kKeyPast;
  for (int step = 0;; ++step) {
    // after the last slot, the trailing frontier pass so post-memory
    // compute counts (one copy of the frontier's code serves both)
    const bool last = step >= p.slots;
    if constexpr (kStream) {
      // the freeze gate at the start of the slot: a row stops at its first
      // frozen slot (f); no trailing pass
      if (last || (!w.final && ptr > n - 4)) break;
      if (!stuck) frontier(4, false);
      if (ptr >= n && free_mask == all_free) break;   // drained: (c)
    } else {
      if (!stuck || last) frontier(last ? 8 : 4, last);
      if (last || (ptr >= n && free_mask == all_free)) break;  // (c)
    }

    // a lane is visible iff valid with t <= cutoff: some lane is iff
    // m <= cutoff, and m is then the earliest visible time
    const int cutoff = wadd(mc_release, vis_slack);
    if (free_mask == all_free || m > cutoff) {
      // idle hop to the next arrival, never on an empty queue: the
      // reference's min over lanes (BIG for free ones), clamped below BIG
      if (free_mask != all_free)
        mc_release = imax(mc_release, imin(m, REPRO_BIG - 1));
      continue;
    }
    const bool val_lo = real_lo && !((free_mask >> lane) & 1ull);
    const bool val_hi = real_hi && !((free_mask >> (lane + 32)) & 1ull);
    const bool vis_lo = val_lo && qlo.t <= cutoff;
    const bool vis_hi = val_hi && qhi.t <= cutoff;
    // each lane's issue time in ticks and refresh count, for whichever
    // lane wins (beside the decision's warp traffic, not after it)
    const int conv_lo = mul_div(qlo.t, kFP, den);
    const int conv_hi = mul_div(qhi.t, kFP, den);
    const int refs_lo = refi.div(conv_lo);
    const int refs_hi = refi.div(conv_hi);

    // ---- scheduling decision: two-level argmin over every lane's key
    // (BIG for invisible lanes), ties to the first lane
    int qslot;
    int2 mit2 = make_int2(0, 0);   // the lanes' mitigate (kFaults)
    if (kPolicy) {
      // write_pressure and age_rel's base only where the program reads them
      const unsigned need = vm_h.env;
      int wp = 0, min_vis = m;
      if (need & (1u << 9))
        wp = __popc(__ballot_sync(kFull, vis_lo && (qlo.flags & kFWrite))) +
             __popc(__ballot_sync(kFull, vis_hi && (qhi.flags & kFWrite)));
      if (need & (1u << 1)) {
        // the reference's min over visible lanes with BIG for the others,
        // which differs from m only past BIG
        const int n_vis = __popc(__ballot_sync(kFull, vis_lo)) +
                          __popc(__ballot_sync(kFull, vis_hi));
        min_vis = n_vis < Q ? imin(m, REPRO_BIG) : m;
      }
      // para_rand's key for this decision, once for every lane
      uint2 kt = make_uint2(0u, 0u);
      if (kFaults && (need & (1u << 11)))
        kt = tf_fold_in(key_of(f.kp0, f.kp1), dram_now);
      // every lane evaluates (a lane not visible is ignored below)
      const int4 sb = scan_policy<kFaults>(
          vm_h, Q > 32, qlo.t, qlo.bank, qlo.row,
          env_flags(qlo.flags, qlo.open, qlo.row, qlo.ready, dram_now),
          qhi.t, qhi.bank, qhi.row,
          env_flags(qhi.flags, qhi.open, qhi.row, qhi.ready, dram_now),
          min_vis, wp, last_bank, nbanks,
          kFaults ? sm_hct[qlo.bank & (SCAN_MAX_BANKS - 1)] : 0,
          kFaults ? sm_hct[qhi.bank & (SCAN_MAX_BANKS - 1)] : 0, kt, mit2);
      const int ka_lo = vis_lo ? imin(sb.x, REPRO_BIG - 1) : past_lo;
      const int ka_hi = vis_hi ? imin(sb.z, REPRO_BIG - 1) : past_hi;
      const bool bo_lo = vis_lo && sb.y != 0;
      const bool bo_hi = vis_hi && sb.w != 0;
      qslot = __ballot_sync(kFull, bo_lo || bo_hi) != 0
                  ? warp_argmin(bo_lo ? ka_lo : past_lo,
                                bo_hi ? ka_hi : past_hi)
                  : warp_argmin(ka_lo, ka_hi);
    } else {
      const bool hit_lo = vis_lo && qlo.open == qlo.row;
      const bool hit_hi = vis_hi && qhi.open == qhi.row;
      const unsigned hits_lo = __ballot_sync(kFull, hit_lo);
      const unsigned hits_hi = __ballot_sync(kFull, hit_hi);
      const unsigned m_lo = __ballot_sync(kFull, vis_lo && qlo.t == m);
      const unsigned m_hi = __ballot_sync(kFull, vis_hi && qhi.t == m);
      const bool use_hit = p.frfcfs && (hits_lo | hits_hi) != 0;
      // every visible key below BIG: the first lane holding m, or the
      // only row hit; otherwise the general argmin
      qslot = use_hit ? first_set(hits_lo, hits_hi) : first_set(m_lo, m_hi);
      if (cutoff >= REPRO_BIG ||
          (use_hit && __popc(hits_lo) + __popc(hits_hi) > 1)) {
        const bool k_lo = use_hit ? hit_lo : vis_lo;
        const bool k_hi = use_hit ? hit_hi : vis_hi;
        qslot = warp_argmin(k_lo ? qlo.t : past_lo, k_hi ? qhi.t : past_hi);
      }
    }
    // ---- the picked request, from the lane that holds it
    const int owner = qslot & 31;
    const bool in_hi = qslot >= 32;
#define REPRO_PICKED(f) __shfl_sync(kFull, in_hi ? qhi.f : qlo.f, owner)
    int pick = REPRO_PICKED(idx);
    int p_t = REPRO_PICKED(t);
    int bk = REPRO_PICKED(bank);
    int rw = REPRO_PICKED(row);
    int fl = REPRO_PICKED(flags);
    int o_row = REPRO_PICKED(open);
    int b_ready = REPRO_PICKED(ready);
    int b_act = REPRO_PICKED(act);
    int p_conv = __shfl_sync(kFull, in_hi ? conv_hi : conv_lo, owner);
    int p_refs = __shfl_sync(kFull, in_hi ? refs_hi : refs_lo, owner);
    // the policy's mitigate of the picked lane (a visible one)
    bool mit = false;
    if (kPolicy && kFaults)
      mit = __shfl_sync(kFull, in_hi ? mit2.y : mit2.x, owner) != 0;
#undef REPRO_PICKED
    if ((free_mask >> qslot) & 1ull) {
      // a free lane won: only when no visible key is below BIG (issue
      // times past 2^30); the reference then serves request 0, the
      // clamp of the free lane's -1. Only a legacy group gets here: a
      // policy group clamps every visible lane's score below BIG, and a
      // decision runs only with a lane visible, so mit (false without a
      // policy) needs no reload
      pick = 0;
      p_t = __ldcg(ti);
      bk = __ldg(bank);
      rw = __ldg(row);
      fl = request_flags(__ldg(kind), weak != nullptr && __ldg(weak) == 0);
      if (retention && weak_cell(key_of(f.kw0, f.kw1), f.weak_fp, bk, rw))
        fl |= kFWeakCell;
      o_row = sm.open[bk];
      b_ready = sm.ready[bk];
      b_act = sm.act[bk];
      p_conv = mul_div(p_t, kFP, den);
      p_refs = refi.div(p_conv);
    }

    // ---- DRAM service (dram.py service_request); the tick conversion
    // of max(t, mc_release) is that of the larger one (after an idle hop
    // mc_release is the picked t), and the refresh count that of the
    // larger of it and dram_now
    const bool from_t = p_t >= mc_release;
    const int decision_t = from_t ? p_t : mc_release;
    int conv = p_conv, conv_refs = p_refs;
    if (!from_t) {
      conv = mul_div(mc_release, kFP, den);
      conv_refs = refi.div(conv);
    }
    const bool from_conv = conv >= dram_now;
    const int now = from_conv ? conv : dram_now;
    const int now_refs = from_conv ? conv_refs : dram_refs;
    const int refs_due = imax(wsub(now_refs, refs_done), 0);
    const Service sv = dram_service(p, now, refs_due, fl, rw, o_row, b_ready,
                                    b_act, bus_busy);
    int ready_next = sv.bank_next;
    if (carry)   // the fault carry; a fired mitigation delays the bank
      ready_next = wadd(
          ready_next,
          fault_slot(p, f, fs, sm_hct, SCAN_MAX_BANKS, vl, bk, rw,
                     (fl & (kFWrite | kFRc | kFNop)) == 0,
                     (fl & kFWeakCell) != 0, sv.hit, now, refs_due > 0, mit,
                     refi));
    sm.open[bk] = rw;
    sm.ready[bk] = ready_next;
    sm.act[bk] = sv.act_next;
    // every lane holding a request to bank bk sees its new state
    if (qlo.bank == bk) {
      qlo.open = rw;
      qlo.ready = ready_next;
      qlo.act = sv.act_next;
    }
    if (qhi.bank == bk) {
      qhi.open = rw;
      qhi.ready = ready_next;
      qhi.act = sv.act_next;
    }
    bus_busy = sv.bus_next;
    refs_done = wadd(refs_done, refs_due);

    // ---- time scaling: response consume-tag in modeled proc cycles
    const int resp_t = imax(wadd(mul_div_fp(sv.t_done, p.scale_num), p.mc_lat),
                            wadd(decision_t, mc_issue));
    tr[pick] = resp_t;
    if (pick < ptr && pick >= ptr - kRing) sm.ring[pick & (kRing - 1)] = resp_t;
    // the service changed t_resp[pick] and freed a lane
    stuck = stuck && !(pick == stuck_w || pick == stuck_d || stuck_full);
    free_mask |= 1ull << qslot;
    {
      const bool v_lo = real_lo && !((free_mask >> lane) & 1ull);
      const bool v_hi = real_hi && !((free_mask >> (lane + 32)) & 1ull);
      m = __reduce_min_sync(kFull, imin(v_lo ? qlo.t : kKeyPast,
                                        v_hi ? qhi.t : kKeyPast));
    }
    mc_release = imax(mc_release, wadd(decision_t, mc_issue));
    dram_now = now;   // now >= dram_now
    dram_refs = now_refs;
    hits += sv.hit ? 1 : 0;
    served += 1;
    smc = wadd(smc, counter_inc);
    last_bank = bk;
  }
  if constexpr (kStream) {   // the row's state back to global memory
    __syncwarp();
    const int nb = p.n_banks;
    int* bs = w.bst + static_cast<size_t>(b) * 3 * nb;
    for (int i = lane; i < nb; i += 32) {
      bs[i] = sm.open[i];
      bs[nb + i] = sm.ready[i];
      bs[2 * nb + i] = sm.act[i];
      if (carry) w.hct[static_cast<size_t>(b) * nb + i] = sm_hct[i];
    }
    int* qrow = w.queue + static_cast<size_t>(b) * Q;
    if (lane < Q) qrow[lane] = ((free_mask >> lane) & 1ull) ? -1 : qlo.idx;
    if (lane + 32 < Q)
      qrow[lane + 32] = ((free_mask >> (lane + 32)) & 1ull) ? -1 : qhi.idx;
    if (lane == 0) {
      int* sc = w.scal + kWinScalars * b;
      sc[0] = ptr;
      sc[1] = mc_release;
      sc[2] = dram_now;
      sc[3] = hits;
      sc[4] = served;
      sc[5] = smc;
      sc[6] = last_bank;
      sc[7] = bus_busy;
      sc[8] = refs_done;
    }
    if (carry) write_fault_stats(fs, fstats + 4 * b);
  } else {
    write_stats(kind, tr, ti, n, hits, served, dram_now, smc, stats + 5 * b);
    if (carry) write_fault_stats(fs, fstats + 4 * b);
  }
}

template <bool kPolicy>
__global__ void __launch_bounds__(32)
slot_scan_kernel(ScanParams p, const int* __restrict__ kinds,
                 const int* __restrict__ banks, const int* __restrict__ rows,
                 const int* __restrict__ deltas, const int* __restrict__ deps,
                 const int8_t* __restrict__ weak_all,
                 const int* __restrict__ tables, const int* __restrict__ costs,
                 int* __restrict__ t_issue, int* __restrict__ t_resp,
                 int* __restrict__ stats) {
  scan_row<kPolicy, false, false>(p, FaultParams{}, kinds, banks, rows, deltas,
                                  deps, weak_all, tables, costs, t_issue,
                                  t_resp, stats, nullptr, nullptr,
                                  WindowIO{});
}

template <bool kPolicy>
__global__ void __launch_bounds__(32)
slot_scan_faults_kernel(ScanParams p, FaultParams f,
                        const int* __restrict__ kinds,
                        const int* __restrict__ banks,
                        const int* __restrict__ rows,
                        const int* __restrict__ deltas,
                        const int* __restrict__ deps,
                        const int8_t* __restrict__ weak_all,
                        const int* __restrict__ tables,
                        const int* __restrict__ costs,
                        int* __restrict__ t_issue, int* __restrict__ t_resp,
                        int* __restrict__ stats, int* __restrict__ fstats,
                        int* __restrict__ vlog) {
  scan_row<kPolicy, true, false>(p, f, kinds, banks, rows, deltas, deps,
                                 weak_all, tables, costs, t_issue, t_resp,
                                 stats, fstats, vlog, WindowIO{});
}

// One stream window of a fast-instantiation group (kStream): legacy or
// policy, with the fault path or without.
template <bool kPolicy, bool kFaults>
__global__ void __launch_bounds__(32)
slot_scan_window_kernel(ScanParams p, FaultParams f, WindowIO w,
                        const int* __restrict__ kinds,
                        const int* __restrict__ banks,
                        const int* __restrict__ rows,
                        const int* __restrict__ deltas,
                        const int* __restrict__ deps,
                        const int8_t* __restrict__ weak_all,
                        const int* __restrict__ tables,
                        const int* __restrict__ costs,
                        int* __restrict__ t_issue, int* __restrict__ t_resp,
                        int* __restrict__ fstats, int* __restrict__ vlog) {
  scan_row<kPolicy, kFaults, true>(p, f, kinds, banks, rows, deltas, deps,
                                   weak_all, tables, costs, t_issue, t_resp,
                                   nullptr, fstats, vlog, w);
}

// ---------------------------------------------------------------------------
// The wide instantiation: any queue, bank count, policy table and window.
//
// The same slot as slot_scan_kernel, for the shapes past its fast
// instantiation (a queue above SCAN_MAX_Q lanes, more than SCAN_MAX_BANKS
// banks, a table above REPRO_VM_MAX_L rows), which the reference takes
// too. One warp per row; queue lane q is held by thread q % 32, its free
// bit is bit q % 32 of word q / 32. The row's state of variable size lives
// in one region laid out at launch (WideLayout): the t_resp ring, the
// queue lanes' requests, the free mask, the bank state (with the fault
// path, the bank counters too) and the decoded policy table with the VM's
// values (one column per thread). The
// region is dynamic shared memory where it fits in 227 KB, else per-row
// global scratch that the wrapper allocates. Every write to it inside the
// slot loop is made by all 32 threads with the same value, so that each
// thread reads its own writes without a barrier. The trace is read
// straight from global memory (no stage), and the frontier is rerun every
// slot (no stuck test).
//
// Exactness: conditions (a)-(d) above, with kRing replaced by the region's
// ring R, a power of two >= max(kRing, window + 8). (a) A pending request
// lies at index >= ptr - window >= ptr - R, so the window read and every
// service of a pending request stay in the ring, whatever the window; a
// dependence more than R back reads global memory as before. (d) Ties
// across words as within one: each thread scans its lanes in increasing q
// with a strict '<', then the warp takes the least key and, among the
// threads that hold it, the least q. The policy environment's age_rel is
// the reference's min over visible lanes with BIG for the others: m, or
// BIG when a lane is not visible and m is past BIG. (e) The fault path
// runs at run time here, as in the fast instantiation, but for the
// retention draw: it is made at service, for a READ.
struct WideLayout {
  int ring;     // R: a power of two
  int nw;       // 32-lane words of the queue
  int o_idx, o_t, o_bank, o_row, o_flags, o_free;
  int o_open, o_ready, o_act, o_hct, o_vm;   // o_vm: a VmLayout, 32 columns
  int total;    // ints per row, a multiple of 4
  int in_smem;  // 1: dynamic shared memory; 0: global scratch
};

// The layout for p; ring 0 when the region cannot be indexed with an int.
WideLayout wide_layout(const ScanParams& p, const FaultParams& f) {
  WideLayout w{};
  long long r = kRing;
  while (r < static_cast<long long>(p.window) + 8) r <<= 1;
  const long long q = p.q, nw = (q + 31) / 32, nb = p.n_banks;
  const long long L = p.table_len > 0 ? p.table_len : 0;
  long long o = r;   // the ring first
  auto take = [&o](long long len) {
    const long long at = o;
    o += len;
    return static_cast<int>(at);
  };
  w.o_idx = take(q);
  w.o_t = take(q);
  w.o_bank = take(q);
  w.o_row = take(q);
  w.o_flags = take(q);
  w.o_free = take(nw);
  w.o_open = take(nb);
  w.o_ready = take(nb);
  w.o_act = take(nb);
  w.o_hct = take(f.faults ? nb : 0);
  o = (o + 3) & ~3LL;   // the decoded program's int4 rows
  if (L > 0) {
    const VmLayout v = vm_layout(static_cast<int>(L), 32);
    if (v.total < 0) return WideLayout{};
    w.o_vm = take(v.total);
  }
  o = (o + 3) & ~3LL;   // the next row's region in global scratch
  if (o > 0x7fffffffLL || r > (1LL << 30)) return WideLayout{};
  w.ring = static_cast<int>(r);
  w.nw = static_cast<int>(nw);
  w.total = static_cast<int>(o);
  w.in_smem = o * static_cast<long long>(sizeof(int)) <= REPRO_MAX_DYN_SMEM;
  return w;
}

__device__ __forceinline__ bool wide_free(const unsigned* fr, int q) {
  return (fr[q >> 5] >> (q & 31)) & 1u;
}

// The first free queue lane: the lowest set bit of the lowest nonzero word
// (the caller knows some lane is free).
__device__ __noinline__ int wide_first_free(const unsigned* fr, int nw) {
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int w = w0 + static_cast<int>(threadIdx.x);
    const unsigned word = w < nw ? fr[w] : 0u;
    const unsigned any = __ballot_sync(kFull, word != 0u);
    if (any != 0u) {
      const int src = __ffs(any) - 1;
      return (w0 + src) * 32 + __ffs(__shfl_sync(kFull, word, src)) - 1;
    }
  }
  return 0;
}

// The lane q of the least key over the warp, each thread holding its own
// least (key, q): ties to the least q.
__device__ __forceinline__ int wide_argmin(int key, int q) {
  const int m = __reduce_min_sync(kFull, key);
  return static_cast<int>(__reduce_min_sync(
      kFull, key == m ? static_cast<unsigned>(q) : 0xffffffffu));
}

// One visible lane's policy score, boost and mitigate (scan_policy above,
// one lane at a time in the thread's column of the region's decoded
// table); hct is its bank's counter, kt the decision's para_rand key.
// Off the fault path (faults false) para_rand keeps its kEnvZero 0, as
// in the fast fault-free kernel and the plain engine.
__device__ __noinline__ int3 wide_policy(int* vm, int t, int bank, int row,
                                         int flags, int q, int min_vis,
                                         int wp, int last_bank,
                                         FloorDiv nbanks, int hct, uint2 kt,
                                         bool faults) {
  const VmHot h = vm_hot(vm);
  int* vals = vm + h.vals;
  const int lane = threadIdx.x;
  const unsigned para = 1u << 11;
  put_env<true>(vals, 32, lane, faults ? h.env : h.env & ~para, t, bank, row,
                flags, q, min_vis, wp, last_bank, nbanks, hct, kt);
  const int col[1] = {lane};
  vm_run<1>(reinterpret_cast<const int4*>(vm + h.prog), h.n_exec, vals, col);
  return make_int3(vals[h.score + lane], vals[h.boost + lane],
                   vals[h.mit + lane]);
}

// One row of the wide instantiation; kStream: a stream window, as in
// scan_row.
template <bool kStream>
__device__ __forceinline__ void wide_row(
    const ScanParams& p, const FaultParams& f, const WideLayout& lay,
    const int* __restrict__ kinds, const int* __restrict__ banks,
    const int* __restrict__ rows, const int* __restrict__ deltas,
    const int* __restrict__ deps, const int8_t* __restrict__ weak_all,
    const int* __restrict__ tables, const int* __restrict__ costs,
    int* __restrict__ t_issue, int* __restrict__ t_resp,
    int* __restrict__ stats, int* __restrict__ fstats,
    int* __restrict__ vlog, int* __restrict__ scratch, const WindowIO& w) {
  extern __shared__ int wide_smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t off = static_cast<size_t>(b) * p.n;
  const int* kind = kinds + off;
  const int* bank = banks + off;
  const int* row = rows + off;
  const int* delta = deltas + off;
  const int* dep = deps + off;
  const int8_t* weak = p.use_weak ? weak_all + off : nullptr;
  int* ti = t_issue + off;
  int* tr = t_resp + off;
  const int n = p.n;
  const int Q = p.q;
  const int L = p.table_len;
  const int R = lay.ring;

  int* region = lay.in_smem ? wide_smem
                            : scratch + static_cast<size_t>(b) * lay.total;
  int* ring = region;
  int* l_idx = region + lay.o_idx;
  int* l_t = region + lay.o_t;
  int* l_bank = region + lay.o_bank;
  int* l_row = region + lay.o_row;
  int* l_flags = region + lay.o_flags;
  unsigned* l_free = reinterpret_cast<unsigned*>(region + lay.o_free);
  int* b_open = region + lay.o_open;
  int* b_ready = region + lay.o_ready;
  int* b_act = region + lay.o_act;
  int* b_hct = region + lay.o_hct;   // with f.faults
  int* vm = region + lay.o_vm;

  for (int i = lane; i < p.n_banks; i += 32) {
    b_open[i] = -1;
    b_ready[i] = 0;
    b_act[i] = 0;
    if (f.faults) b_hct[i] = 0;
  }
  const bool carry = f.victim_slots > 0;   // with f.faults: the wrapper
  FaultState fs{0, 0, 0, 0};
  int* vl = carry ? vlog + static_cast<size_t>(b) * 3 * f.victim_slots
                  : nullptr;
  for (int w = lane; w < lay.nw; w += 32) {
    const int rest = Q - 32 * w;
    l_free[w] = rest >= 32 ? ~0u : (1u << rest) - 1u;
  }
  if (L > 0)
    vm_prepare_warp(tables + static_cast<size_t>(b) * (L + 1) * 4, L, 32, vm,
                    vm_layout(L, 32), false, kEnvZero);
  __syncwarp();

  const int counter_inc = costs[2 * b];
  const int smc_lat = costs[2 * b + 1];
  const int mc_issue = p.nots ? smc_lat : p.mc_issue_ts;
  const int vis_slack = p.nots ? smc_lat : 0;
  const FloorDiv den(imax(p.scale_num, 1));
  const FloorDiv refi(p.tREFI);
  const FloorDiv nbanks(p.n_banks);
  const bool win_ok = p.window >= 1;

  int nfree = Q;
  int m = kKeyPast;   // earliest t over the valid lanes
  int ptr = 0, prev_ti = 0;
  int bus_busy = 0, refs_done = 0, mc_release = 0, dram_now = 0;
  int hits = 0, served = 0, smc = 0, last_bank = -1;
  if constexpr (kStream) {   // the window's row state, as in scan_row
    const int nb = p.n_banks;
    const int* bs = w.bst + static_cast<size_t>(b) * 3 * nb;
    for (int i = lane; i < nb; i += 32) {
      b_open[i] = bs[i];
      b_ready[i] = bs[nb + i];
      b_act[i] = bs[2 * nb + i];
      if (carry) b_hct[i] = w.hct[static_cast<size_t>(b) * nb + i];
    }
    if (carry) {
      const int* fc = fstats + 4 * b;
      fs = FaultState{fc[0], fc[1], fc[2], fc[3]};
    }
    const int* sc = w.scal + kWinScalars * b;
    ptr = sc[0];
    mc_release = sc[1];
    dram_now = sc[2];
    hits = sc[3];
    served = sc[4];
    smc = sc[5];
    last_bank = sc[6];
    bus_busy = sc[7];
    refs_done = sc[8];
    prev_ti = ptr > 0 ? __ldcg(ti + ptr - 1) : 0;
    for (int i = imax(ptr - R, 0) + lane; i < ptr; i += 32)
      ring[i & (R - 1)] = __ldcg(tr + i);
    const int* qrow = w.queue + static_cast<size_t>(b) * Q;
    int busy = 0, mv = kKeyPast;
    for (int q = lane; q < Q; q += 32) {
      const int idx = qrow[q];
      if (idx < 0) continue;
      l_idx[q] = idx;
      l_t[q] = __ldcg(ti + idx);
      l_bank[q] = __ldg(bank + idx);
      l_row[q] = __ldg(row + idx);
      l_flags[q] = request_flags(__ldg(kind + idx),
                                 weak != nullptr && __ldg(weak + idx) == 0);
      ++busy;
      mv = imin(mv, l_t[q]);
    }
    for (int wd = lane; wd < lay.nw; wd += 32) {
      unsigned bits = 0u;
      for (int k = 0; k < 32 && 32 * wd + k < Q; ++k)
        if (qrow[32 * wd + k] < 0) bits |= 1u << k;
      l_free[wd] = bits;
    }
    nfree = Q - __reduce_add_sync(kFull, busy);
    m = __reduce_min_sync(kFull, mv);
    __syncwarp();
  }

  // emulator.py _issue_frontier, as in slot_scan_kernel
  auto frontier = [&](int upto, bool trailing) {
    for (int u = 0; u < upto && ptr < n; ++u) {
      const int j = ptr;
      const int kd = __ldg(kind + j);
      const int dpj = __ldg(dep + j);
      const bool is_nop = kd == kNop;
      const int wj = wsub(j, p.window);
      const int wi = wj >= 0 ? imin(wj, n - 1) : -1;
      const int dj = wsub(j, dpj);
      const int di = dpj > 0 && dj >= 0 ? dj : -1;
      const int tw = wi >= 0 && win_ok ? ring[wi & (R - 1)] : REPRO_BIG;
      int td = REPRO_BIG;
      if (di >= 0) td = di >= ptr - R ? ring[di & (R - 1)] : __ldcg(tr + di);
      if (!((wi < 0 || tw < REPRO_BIG) && (di < 0 || td < REPRO_BIG) &&
            (nfree > 0 || is_nop)))
        return;
      const int t_new = imax(imax(wadd(prev_ti, __ldg(delta + j)),
                                  wi >= 0 ? wadd(tw, 1) : 0),
                             di >= 0 ? wadd(td, 1) : 0);
      ti[j] = t_new;
      ring[j & (R - 1)] = is_nop ? t_new : REPRO_BIG;
      if (is_nop && !trailing) tr[j] = t_new;
      if (!is_nop) {
        const int s = wide_first_free(l_free, lay.nw);
        l_idx[s] = j;
        l_t[s] = t_new;
        l_bank[s] = __ldg(bank + j);
        l_row[s] = __ldg(row + j);
        l_flags[s] =
            request_flags(kd, weak != nullptr && __ldg(weak + j) == 0);
        l_free[s >> 5] &= ~(1u << (s & 31));
        --nfree;
        m = imin(m, t_new);
      }
      prev_ti = t_new;
      ++ptr;
    }
  };

  for (int step = 0;; ++step) {
    const bool last = step >= p.slots;
    if constexpr (kStream) {   // the freeze gate (f); no trailing pass
      if (last || (!w.final && ptr > n - 4)) break;
      frontier(4, false);
    } else {
      frontier(last ? 8 : 4, last);
    }
    if (last || (ptr >= n && nfree == Q)) break;   // drained: (c)
    const int cutoff = wadd(mc_release, vis_slack);
    if (nfree == Q || m > cutoff) {
      if (nfree != Q) mc_release = imax(mc_release, imin(m, REPRO_BIG - 1));
      continue;
    }

    // ---- scheduling decision: keys BIG for lanes not visible
    int qslot;
    bool mit = false;   // the picked lane's mitigate
    if (L > 0) {
      int wp = 0, vis = 0;
      for (int q = lane; q < Q; q += 32) {
        if (wide_free(l_free, q) || l_t[q] > cutoff) continue;
        ++vis;
        wp += (l_flags[q] & kFWrite) ? 1 : 0;
      }
      wp = __reduce_add_sync(kFull, wp);
      vis = __reduce_add_sync(kFull, vis);
      const int min_vis = vis < Q ? imin(m, REPRO_BIG) : m;
      uint2 kt = make_uint2(0u, 0u);   // para_rand's key, if drawn
      if (f.faults && (vm[repro_vm::kHEnv] & (1 << 11)))
        kt = tf_fold_in(key_of(f.kp0, f.kp1), dram_now);
      // each thread's least key and lane, and that lane's mitigate
      int ka = kKeyPast, qa = Q, kb = kKeyPast, qb = Q, ma = 0, mb = 0;
      bool boosted = false;
      for (int q = lane; q < Q; q += 32) {
        int key_a = REPRO_BIG, key_b = REPRO_BIG, mq = 0;
        if (!wide_free(l_free, q) && l_t[q] <= cutoff) {
          const int bk = l_bank[q];
          const int3 sb = wide_policy(
              vm, l_t[q], bk, l_row[q],
              env_flags(l_flags[q], b_open[bk], l_row[q], b_ready[bk],
                        dram_now),
              q, min_vis, wp, last_bank, nbanks, f.faults ? b_hct[bk] : 0,
              kt, f.faults != 0);
          key_a = imin(sb.x, REPRO_BIG - 1);
          mq = sb.z;
          if (sb.y != 0) {
            key_b = key_a;
            boosted = true;
          }
        }
        if (key_a < ka) {
          ka = key_a;
          qa = q;
          ma = mq;
        }
        if (key_b < kb) {
          kb = key_b;
          qb = q;
          mb = mq;
        }
      }
      // the winner is its owner thread's least lane
      const bool any_boost = __any_sync(kFull, boosted);
      qslot = any_boost ? wide_argmin(kb, qb) : wide_argmin(ka, qa);
      mit = __shfl_sync(kFull, any_boost ? mb : ma, qslot & 31) != 0;
    } else {
      int ka = kKeyPast, qa = Q, kh = kKeyPast, qh = Q;
      bool any_hit = false;
      for (int q = lane; q < Q; q += 32) {
        int key_a = REPRO_BIG, key_h = REPRO_BIG;
        if (!wide_free(l_free, q) && l_t[q] <= cutoff) {
          key_a = l_t[q];
          if (b_open[l_bank[q]] == l_row[q]) {
            key_h = key_a;
            any_hit = true;
          }
        }
        if (key_a < ka) {
          ka = key_a;
          qa = q;
        }
        if (key_h < kh) {
          kh = key_h;
          qh = q;
        }
      }
      const bool use_hit = p.frfcfs && __any_sync(kFull, any_hit);
      qslot = use_hit ? wide_argmin(kh, qh) : wide_argmin(ka, qa);
    }

    // ---- the picked request; a free lane wins only when no visible key
    // is below BIG, and the reference then serves request 0 (a legacy
    // group only: a policy group's visible scores are clamped below BIG,
    // so its mit is always a visible lane's)
    const bool won_free = wide_free(l_free, qslot);
    int pick = 0, p_t, bk, rw, fl;
    if (!won_free) {
      pick = l_idx[qslot];
      p_t = l_t[qslot];
      bk = l_bank[qslot];
      rw = l_row[qslot];
      fl = l_flags[qslot];
    } else {
      p_t = __ldcg(ti);
      bk = __ldg(bank);
      rw = __ldg(row);
      fl = request_flags(__ldg(kind), weak != nullptr && __ldg(weak) == 0);
    }

    // ---- DRAM service (dram.py service_request)
    const int decision_t = imax(p_t, mc_release);
    const int now = imax(dram_now, mul_div(decision_t, kFP, den));
    const int refs_due = imax(wsub(refi.div(now), refs_done), 0);
    const Service sv = dram_service(p, now, refs_due, fl, rw, b_open[bk],
                                    b_ready[bk], b_act[bk], bus_busy);
    int ready_next = sv.bank_next;
    if (carry) {   // the fault carry; the retention draw at service
      const bool is_read = (fl & (kFWrite | kFRc | kFNop)) == 0;
      const bool weak_row = f.weak_fp > 0 && is_read &&
                            weak_cell(key_of(f.kw0, f.kw1), f.weak_fp, bk, rw);
      ready_next = wadd(
          ready_next, fault_slot(p, f, fs, b_hct, p.n_banks, vl, bk, rw,
                                 is_read, weak_row, sv.hit, now,
                                 refs_due > 0, mit, refi));
    }
    b_open[bk] = rw;
    b_ready[bk] = ready_next;
    b_act[bk] = sv.act_next;
    bus_busy = sv.bus_next;
    refs_done = wadd(refs_done, refs_due);

    // ---- time scaling: response consume-tag in modeled proc cycles
    const int resp_t = imax(wadd(mul_div_fp(sv.t_done, p.scale_num), p.mc_lat),
                            wadd(decision_t, mc_issue));
    tr[pick] = resp_t;
    if (pick < ptr && pick >= ptr - R) ring[pick & (R - 1)] = resp_t;
    if (!won_free) {
      l_free[qslot >> 5] |= 1u << (qslot & 31);
      ++nfree;
    }
    int mv = kKeyPast;
    for (int q = lane; q < Q; q += 32)
      if (!wide_free(l_free, q)) mv = imin(mv, l_t[q]);
    m = __reduce_min_sync(kFull, mv);
    mc_release = imax(mc_release, wadd(decision_t, mc_issue));
    dram_now = now;
    hits += sv.hit ? 1 : 0;
    served += 1;
    smc = wadd(smc, counter_inc);
    last_bank = bk;
  }
  if constexpr (kStream) {   // the row's state back to global memory
    __syncwarp();
    const int nb = p.n_banks;
    int* bs = w.bst + static_cast<size_t>(b) * 3 * nb;
    for (int i = lane; i < nb; i += 32) {
      bs[i] = b_open[i];
      bs[nb + i] = b_ready[i];
      bs[2 * nb + i] = b_act[i];
      if (carry) w.hct[static_cast<size_t>(b) * nb + i] = b_hct[i];
    }
    int* qrow = w.queue + static_cast<size_t>(b) * Q;
    for (int q = lane; q < Q; q += 32)
      qrow[q] = wide_free(l_free, q) ? -1 : l_idx[q];
    if (lane == 0) {
      int* sc = w.scal + kWinScalars * b;
      sc[0] = ptr;
      sc[1] = mc_release;
      sc[2] = dram_now;
      sc[3] = hits;
      sc[4] = served;
      sc[5] = smc;
      sc[6] = last_bank;
      sc[7] = bus_busy;
      sc[8] = refs_done;
    }
    if (carry) write_fault_stats(fs, fstats + 4 * b);
  } else {
    write_stats(kind, tr, ti, n, hits, served, dram_now, smc, stats + 5 * b);
    if (carry) write_fault_stats(fs, fstats + 4 * b);
  }
}

__global__ void __launch_bounds__(32)
slot_scan_wide_kernel(ScanParams p, FaultParams f, WideLayout lay,
                      const int* __restrict__ kinds,
                      const int* __restrict__ banks,
                      const int* __restrict__ rows,
                      const int* __restrict__ deltas,
                      const int* __restrict__ deps,
                      const int8_t* __restrict__ weak_all,
                      const int* __restrict__ tables,
                      const int* __restrict__ costs, int* __restrict__ t_issue,
                      int* __restrict__ t_resp, int* __restrict__ stats,
                      int* __restrict__ fstats, int* __restrict__ vlog,
                      int* __restrict__ scratch) {
  wide_row<false>(p, f, lay, kinds, banks, rows, deltas, deps, weak_all,
                  tables, costs, t_issue, t_resp, stats, fstats, vlog, scratch,
                  WindowIO{});
}

// One stream window of a wide-instantiation group.
__global__ void __launch_bounds__(32)
slot_scan_window_wide_kernel(ScanParams p, FaultParams f, WideLayout lay,
                             WindowIO w, const int* __restrict__ kinds,
                             const int* __restrict__ banks,
                             const int* __restrict__ rows,
                             const int* __restrict__ deltas,
                             const int* __restrict__ deps,
                             const int8_t* __restrict__ weak_all,
                             const int* __restrict__ tables,
                             const int* __restrict__ costs,
                             int* __restrict__ t_issue,
                             int* __restrict__ t_resp,
                             int* __restrict__ fstats,
                             int* __restrict__ vlog,
                             int* __restrict__ scratch) {
  wide_row<true>(p, f, lay, kinds, banks, rows, deltas, deps, weak_all,
                 tables, costs, t_issue, t_resp, nullptr, fstats, vlog,
                 scratch, w);
}

}  // namespace

extern "C" int slot_scan_num_params() { return kNumParams; }

// The two structs from the host's flat parameter block.
static void read_params(const int* params, ScanParams& p, FaultParams& f) {
  constexpr int np = sizeof(ScanParams) / sizeof(int);
  int* dp = reinterpret_cast<int*>(&p);
  int* df = reinterpret_cast<int*>(&f);
  for (int i = 0; i < np; ++i) dp[i] = params[i];
  for (int i = np; i < kNumParams; ++i) df[i - np] = params[i];
}

// Global scratch (ints) the wide instantiation needs for this group: 0
// when a row's region fits in shared memory, -1 when it is too large to
// index.
extern "C" long long slot_scan_wide_scratch_ints(const int* params) {
  ScanParams p;
  FaultParams f;
  read_params(params, p, f);
  const WideLayout lay = wide_layout(p, f);
  if (lay.ring == 0) return -1;
  return lay.in_smem ? 0 : static_cast<long long>(p.batch) * lay.total;
}

extern "C" int slot_scan_wide_launch(const int* params, const void* kind,
                                     const void* bank, const void* row,
                                     const void* delta, const void* dep,
                                     const void* weak, const void* tables,
                                     const void* costs, void* t_issue,
                                     void* t_resp, void* stats, void* fstats,
                                     void* vlog, void* scratch,
                                     void* stream) {
  ScanParams p;
  FaultParams f;
  read_params(params, p, f);
  if (p.batch <= 0) return 0;
  const WideLayout lay = wide_layout(p, f);
  if (lay.ring == 0 || (!lay.in_smem && scratch == nullptr) ||
      (f.victim_slots > 0 && (!f.faults || fstats == nullptr ||
                              vlog == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (lay.in_smem) {
    smem = static_cast<size_t>(lay.total) * sizeof(int);
    const cudaError_t e = cudaFuncSetAttribute(
        slot_scan_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  slot_scan_wide_kernel<<<p.batch, 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      p, f, lay, static_cast<const int*>(kind), static_cast<const int*>(bank),
      static_cast<const int*>(row), static_cast<const int*>(delta),
      static_cast<const int*>(dep), static_cast<const int8_t*>(weak),
      static_cast<const int*>(tables), static_cast<const int*>(costs),
      static_cast<int*>(t_issue), static_cast<int*>(t_resp),
      static_cast<int*>(stats), static_cast<int*>(fstats),
      static_cast<int*>(vlog), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// A policy kernel of the fast instantiation opted, once per process, into
// all the dynamic shared memory its static shared memory leaves.
template <typename Kernel>
static cudaError_t opt_in_policy_smem(Kernel kernel) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(REPRO_MAX_DYN_SMEM - a.sharedSizeBytes));
}

// The fast instantiation: queue <= SCAN_MAX_Q, banks <= SCAN_MAX_BANKS,
// table <= REPRO_VM_MAX_L (the wrapper picks it by shape), legacy or
// policy, with the fault path (f.faults: its own kernel) or without. The
// policy VM's region is dynamic shared memory (none for a legacy group).
extern "C" int slot_scan_launch(const int* params, const void* kind,
                                const void* bank, const void* row,
                                const void* delta, const void* dep,
                                const void* weak, const void* tables,
                                const void* costs, void* t_issue,
                                void* t_resp, void* stats, void* fstats,
                                void* vlog, void* stream) {
  ScanParams p;
  FaultParams f;
  read_params(params, p, f);
  if (p.batch <= 0) return 0;
  if (f.victim_slots > 0 &&
      (!f.faults || fstats == nullptr || vlog == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (p.table_len > 0) {
    if (p.table_len > REPRO_VM_MAX_L)
      return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t attr_plain =
        opt_in_policy_smem(slot_scan_kernel<true>);
    static const cudaError_t attr_faults =
        opt_in_policy_smem(slot_scan_faults_kernel<true>);
    const cudaError_t attr = f.faults ? attr_faults : attr_plain;
    if (attr != cudaSuccess) return static_cast<int>(attr);
    smem = static_cast<size_t>(
               vm_layout(p.table_len, scan_vm_cols(p.q)).total) * 4;
  }
  const auto i = [](const void* x) { return static_cast<const int*>(x); };
  const auto o = [](void* x) { return static_cast<int*>(x); };
  const auto w = static_cast<const int8_t*>(weak);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f.faults) {
    const auto kernel = p.table_len > 0 ? slot_scan_faults_kernel<true>
                                        : slot_scan_faults_kernel<false>;
    kernel<<<p.batch, 32, smem, st>>>(
        p, f, i(kind), i(bank), i(row), i(delta), i(dep), w, i(tables),
        i(costs), o(t_issue), o(t_resp), o(stats), o(fstats), o(vlog));
  } else {
    const auto kernel = p.table_len > 0 ? slot_scan_kernel<true>
                                        : slot_scan_kernel<false>;
    kernel<<<p.batch, 32, smem, st>>>(
        p, i(kind), i(bank), i(row), i(delta), i(dep), w, i(tables),
        i(costs), o(t_issue), o(t_resp), o(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

// One stream window (kStream) of a group, in the fast instantiation (wide
// 0) or the wide one (wide 1; scratch as for slot_scan_wide_launch). bufs:
// kind, bank, row, delta, dep, weak, tables, costs, t_issue, t_resp (in
// and out), then WindowIO's queue, scal, bst and hct, then fstats (the
// fault counters [batch][4], in and out) and vlog, each nullptr where the
// group has none.
extern "C" int slot_scan_window_launch(const int* params, int final,
                                       void* const* bufs, int wide,
                                       void* scratch, void* stream) {
  ScanParams p;
  FaultParams f;
  read_params(params, p, f);
  if (p.batch <= 0) return 0;
  const auto i = [bufs](int k) { return static_cast<const int*>(bufs[k]); };
  const auto o = [bufs](int k) { return static_cast<int*>(bufs[k]); };
  const auto wk = static_cast<const int8_t*>(bufs[5]);
  const WindowIO w{o(10), o(11), o(12), o(13), final};
  int* fstats = o(14);
  int* vlog = o(15);
  if (w.queue == nullptr || w.scal == nullptr || w.bst == nullptr ||
      (f.victim_slots > 0 &&
       (!f.faults || fstats == nullptr || vlog == nullptr ||
        w.hct == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    const WideLayout lay = wide_layout(p, f);
    if (lay.ring == 0 || (!lay.in_smem && scratch == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    size_t smem = 0;
    if (lay.in_smem) {
      smem = static_cast<size_t>(lay.total) * sizeof(int);
      const cudaError_t e = cudaFuncSetAttribute(
          slot_scan_window_wide_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    slot_scan_window_wide_kernel<<<p.batch, 32, smem, st>>>(
        p, f, lay, w, i(0), i(1), i(2), i(3), i(4), wk, i(6), i(7), o(8),
        o(9), fstats, vlog, static_cast<int*>(scratch));
    return static_cast<int>(cudaGetLastError());
  }
  size_t smem = 0;
  if (p.table_len > 0) {
    if (p.table_len > REPRO_VM_MAX_L)
      return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t attr_plain =
        opt_in_policy_smem(slot_scan_window_kernel<true, false>);
    static const cudaError_t attr_faults =
        opt_in_policy_smem(slot_scan_window_kernel<true, true>);
    const cudaError_t attr = f.faults ? attr_faults : attr_plain;
    if (attr != cudaSuccess) return static_cast<int>(attr);
    smem = static_cast<size_t>(
               vm_layout(p.table_len, scan_vm_cols(p.q)).total) * 4;
  }
  const auto kernel =
      p.table_len > 0
          ? (f.faults ? slot_scan_window_kernel<true, true>
                      : slot_scan_window_kernel<true, false>)
          : (f.faults ? slot_scan_window_kernel<false, true>
                      : slot_scan_window_kernel<false, false>);
  kernel<<<p.batch, 32, smem, st>>>(p, f, w, i(0), i(1), i(2), i(3), i(4), wk,
                                    i(6), i(7), o(8), o(9), fstats, vlog);
  return static_cast<int>(cudaGetLastError());
}
