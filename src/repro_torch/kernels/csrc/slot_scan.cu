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
//   With a policy table every visible lane runs the VM body of
//   policy_vm.cuh in its own thread, all at once.
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
// - Rarely taken paths (staging, the policy VM, a key at BIG) are out
//   of line or behind one branch, so that the slot loop stays compact.
// - Row state on chip, in shared memory: the bank state, the policy
//   table, a stage of the trace ahead of the issue pointer (filled by the
//   warp with coalesced loads, kStage / 2 entries at a time) and a ring of
//   the t_resp of the last kRing issued requests. t_issue / t_resp are
//   written through to global memory as they are set; the outputs are
//   those global arrays.
// - A row stops once it has drained (condition (c) below), so the
//   surplus slots of a group's budget cost nothing.
//
// The Bloom probe is not in the loop: its key depends only on the
// request, so the wrapper probes every request once (bloom_probe kernel)
// and this kernel reads one int8 flag per request.
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
#include <cuda_runtime.h>

#include "common.cuh"
#include "policy_vm.cuh"

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
// a request's flags, from its kind and (with weak flags) weak row
constexpr int kFWrite = 1, kFRc = 2, kFNop = 4, kFWeak0 = 8;

// Host parameter block, in this order (see slot_scan.py).
struct ScanParams {
  int batch, n, window, q, slots, n_banks, n_rows;
  int scale_num, mc_lat, mc_issue_ts, nots, frfcfs, table_len, use_weak;
  int tRCD, tRCD_reduced, tCL, tRP, tRAS, tWR, tBL, tRFC, tREFI, tRC_CLONE;
};
constexpr int kNumParams = sizeof(ScanParams) / sizeof(int);

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
  int table[(REPRO_VM_MAX_L + 1) * 4];
};
__shared__ RowState sm;

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

// One visible lane's policy score and boost: the VM body of
// policy_vm.cuh over its scheduling environment (hammer_ct, para_rand:
// no fault model).
__device__ __noinline__ int2 lane_policy(int L, Lane x, int q, int min_vis,
                                         int wp, int dram_now, int last_bank,
                                         FloorDiv nbanks) {
  int env[REPRO_N_LOADS];
  int vals[REPRO_VM_MAX_L];
  env[0] = x.t;                                           // age
  env[1] = wsub(x.t, min_vis);                            // age_rel
  env[2] = x.open == x.row ? 1 : 0;                       // row_hit
  env[3] = x.bank;                                        // bank
  env[4] = x.row;                                         // row
  env[5] = (x.flags & kFWrite) ? 1 : 0;                   // is_write
  env[6] = x.ready > dram_now ? 1 : 0;                    // bank_busy
  env[7] = nbanks.mod(wsub(wsub(x.bank, last_bank), 1));  // rr_dist
  env[8] = q;                                             // qslot
  env[9] = wp;                                            // write_pressure
  env[10] = 0;                                            // hammer_ct
  env[11] = 0;                                            // para_rand
  int score, boost, mit;
  policy_vm_lane(sm.table, L, env, vals, &score, &boost, &mit);
  return make_int2(score, boost);
}

__global__ void __launch_bounds__(32)
slot_scan_kernel(ScanParams p, const int* __restrict__ kinds,
                 const int* __restrict__ banks, const int* __restrict__ rows,
                 const int* __restrict__ deltas, const int* __restrict__ deps,
                 const int8_t* __restrict__ weak_all,
                 const int* __restrict__ tables, const int* __restrict__ costs,
                 int* __restrict__ t_issue, int* __restrict__ t_resp,
                 int* __restrict__ stats) {
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

  if (L > 0) {
    const int n_tab = (L + 1) * 4;
    for (int i = lane; i < n_tab; i += 32)
      sm.table[i] = tables[static_cast<size_t>(b) * n_tab + i];
  }
  for (int i = lane; i < SCAN_MAX_BANKS; i += 32) {
    sm.open[i] = -1;
    sm.ready[i] = 0;
    sm.act[i] = 0;
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
  int hi = imin(n, kStage);
  stage_fill(kind, bank, row, delta, dep, weak, 0, hi);
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
  int ptr = 0, prev_ti = 0;
  Next nx = next_at(0);
  // the frontier failed at ptr and none of its inputs there (t_resp at
  // stuck_w and stuck_d, a free lane if stuck_full) has changed since:
  // it would fail again at once, so it is not run
  bool stuck = false, stuck_full = false;
  int stuck_w = -1, stuck_d = -1;
  int bus_busy = 0, refs_done = 0, mc_release = 0, dram_now = 0;
  int hits = 0, served = 0, smc = 0, last_bank = -1;
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
    if (!stuck || last) frontier(last ? 8 : 4, last);
    if (last || (ptr >= n && free_mask == all_free)) break;  // drained: (c)

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
    if (L > 0) {
      const int wp =
          __popc(__ballot_sync(kFull, vis_lo && (qlo.flags & kFWrite))) +
          __popc(__ballot_sync(kFull, vis_hi && (qhi.flags & kFWrite)));
      // age_rel's base: the reference's min over visible lanes with BIG
      // for the others, which differs from m only past BIG
      const int n_vis = __popc(__ballot_sync(kFull, vis_lo)) +
                        __popc(__ballot_sync(kFull, vis_hi));
      const int min_vis = n_vis < Q ? imin(m, REPRO_BIG) : m;
      int ka_lo = past_lo, ka_hi = past_hi, kb_lo = past_lo, kb_hi = past_hi;
      bool boosted = false;
      int score, boost;
      if (vis_lo) {
        const int2 sb = lane_policy(L, qlo, lane, min_vis, wp, dram_now,
                                    last_bank, nbanks);
        score = sb.x;
        boost = sb.y;
        ka_lo = imin(score, REPRO_BIG - 1);
        if (boost != 0) {
          kb_lo = ka_lo;
          boosted = true;
        }
      }
      if (vis_hi) {
        const int2 sb = lane_policy(L, qhi, lane + 32, min_vis, wp,
                                    dram_now, last_bank, nbanks);
        score = sb.x;
        boost = sb.y;
        ka_hi = imin(score, REPRO_BIG - 1);
        if (boost != 0) {
          kb_hi = ka_hi;
          boosted = true;
        }
      }
      qslot = __ballot_sync(kFull, boosted) != 0 ? warp_argmin(kb_lo, kb_hi)
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
#undef REPRO_PICKED
    if ((free_mask >> qslot) & 1ull) {
      // a free lane won: only when no visible key is below BIG (issue
      // times past 2^30); the reference then serves request 0, the
      // clamp of the free lane's -1
      pick = 0;
      p_t = __ldcg(ti);
      bk = __ldg(bank);
      rw = __ldg(row);
      fl = request_flags(__ldg(kind), weak != nullptr && __ldg(weak) == 0);
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
    sm.open[bk] = rw;
    sm.ready[bk] = sv.bank_next;
    sm.act[bk] = sv.act_next;
    // every lane holding a request to bank bk sees its new state
    if (qlo.bank == bk) {
      qlo.open = rw;
      qlo.ready = sv.bank_next;
      qlo.act = sv.act_next;
    }
    if (qhi.bank == bk) {
      qhi.open = rw;
      qhi.ready = sv.bank_next;
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
  write_stats(kind, tr, ti, n, hits, served, dram_now, smc, stats + 5 * b);
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
// queue lanes' requests, the free mask, the bank state, the policy table
// and the VM's values (L per thread, interleaved across the warp). The
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
// BIG when a lane is not visible and m is past BIG.
struct WideLayout {
  int ring;     // R: a power of two
  int nw;       // 32-lane words of the queue
  int o_idx, o_t, o_bank, o_row, o_flags, o_free;
  int o_open, o_ready, o_act, o_table, o_vals;
  int total;    // ints per row
  int in_smem;  // 1: dynamic shared memory; 0: global scratch
};

// The layout for p; ring 0 when the region cannot be indexed with an int.
WideLayout wide_layout(const ScanParams& p) {
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
  w.o_table = take(L > 0 ? (L + 1) * 4 : 0);
  w.o_vals = take(32 * L);
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

// One visible lane's policy score and boost (lane_policy above, with the
// lane's request and its bank's state read from the region).
__device__ __noinline__ int2 wide_lane_policy(const int* table, int L,
                                              int* vals, int t, int bank,
                                              int row, int flags, int q,
                                              int min_vis, int wp, int open,
                                              int ready, int dram_now,
                                              int last_bank,
                                              FloorDiv nbanks) {
  int env[REPRO_N_LOADS];
  env[0] = t;                                             // age
  env[1] = wsub(t, min_vis);                              // age_rel
  env[2] = open == row ? 1 : 0;                           // row_hit
  env[3] = bank;                                          // bank
  env[4] = row;                                           // row
  env[5] = (flags & kFWrite) ? 1 : 0;                     // is_write
  env[6] = ready > dram_now ? 1 : 0;                      // bank_busy
  env[7] = nbanks.mod(wsub(wsub(bank, last_bank), 1));    // rr_dist
  env[8] = q;                                             // qslot
  env[9] = wp;                                            // write_pressure
  env[10] = 0;                                            // hammer_ct
  env[11] = 0;                                            // para_rand
  int score, boost, mit;
  policy_vm_lane(table, L, env, vals, &score, &boost, &mit, 32);
  return make_int2(score, boost);
}

__global__ void __launch_bounds__(32)
slot_scan_wide_kernel(ScanParams p, WideLayout lay,
                      const int* __restrict__ kinds,
                      const int* __restrict__ banks,
                      const int* __restrict__ rows,
                      const int* __restrict__ deltas,
                      const int* __restrict__ deps,
                      const int8_t* __restrict__ weak_all,
                      const int* __restrict__ tables,
                      const int* __restrict__ costs, int* __restrict__ t_issue,
                      int* __restrict__ t_resp, int* __restrict__ stats,
                      int* __restrict__ scratch) {
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
  int* table = region + lay.o_table;
  int* vals = region + lay.o_vals + lane;

  for (int i = lane; i < p.n_banks; i += 32) {
    b_open[i] = -1;
    b_ready[i] = 0;
    b_act[i] = 0;
  }
  for (int w = lane; w < lay.nw; w += 32) {
    const int rest = Q - 32 * w;
    l_free[w] = rest >= 32 ? ~0u : (1u << rest) - 1u;
  }
  if (L > 0) {
    const int n_tab = (L + 1) * 4;
    for (int i = lane; i < n_tab; i += 32)
      table[i] = tables[static_cast<size_t>(b) * n_tab + i];
  }
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
    frontier(last ? 8 : 4, last);
    if (last || (ptr >= n && nfree == Q)) break;   // drained: (c)
    const int cutoff = wadd(mc_release, vis_slack);
    if (nfree == Q || m > cutoff) {
      if (nfree != Q) mc_release = imax(mc_release, imin(m, REPRO_BIG - 1));
      continue;
    }

    // ---- scheduling decision: keys BIG for lanes not visible
    int qslot;
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
      int ka = kKeyPast, qa = Q, kb = kKeyPast, qb = Q;
      bool boosted = false;
      for (int q = lane; q < Q; q += 32) {
        int key_a = REPRO_BIG, key_b = REPRO_BIG;
        if (!wide_free(l_free, q) && l_t[q] <= cutoff) {
          const int bk = l_bank[q];
          const int2 sb = wide_lane_policy(
              table, L, vals, l_t[q], bk, l_row[q], l_flags[q], q, min_vis,
              wp, b_open[bk], b_ready[bk], dram_now, last_bank, nbanks);
          key_a = imin(sb.x, REPRO_BIG - 1);
          if (sb.y != 0) {
            key_b = key_a;
            boosted = true;
          }
        }
        if (key_a < ka) {
          ka = key_a;
          qa = q;
        }
        if (key_b < kb) {
          kb = key_b;
          qb = q;
        }
      }
      qslot = __any_sync(kFull, boosted) ? wide_argmin(kb, qb)
                                         : wide_argmin(ka, qa);
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
    // is below BIG, and the reference then serves request 0
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
    b_open[bk] = rw;
    b_ready[bk] = sv.bank_next;
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
  write_stats(kind, tr, ti, n, hits, served, dram_now, smc, stats + 5 * b);
}

}  // namespace

extern "C" int slot_scan_num_params() { return kNumParams; }

static ScanParams read_params(const int* params) {
  ScanParams p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kNumParams; ++i) dst[i] = params[i];
  return p;
}

// Global scratch (ints) the wide instantiation needs for this group: 0
// when a row's region fits in shared memory, -1 when it is too large to
// index.
extern "C" long long slot_scan_wide_scratch_ints(const int* params) {
  const ScanParams p = read_params(params);
  const WideLayout lay = wide_layout(p);
  if (lay.ring == 0) return -1;
  return lay.in_smem ? 0 : static_cast<long long>(p.batch) * lay.total;
}

extern "C" int slot_scan_wide_launch(const int* params, const void* kind,
                                     const void* bank, const void* row,
                                     const void* delta, const void* dep,
                                     const void* weak, const void* tables,
                                     const void* costs, void* t_issue,
                                     void* t_resp, void* stats, void* scratch,
                                     void* stream) {
  const ScanParams p = read_params(params);
  if (p.batch <= 0) return 0;
  const WideLayout lay = wide_layout(p);
  if (lay.ring == 0 || (!lay.in_smem && scratch == nullptr))
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
      p, lay, static_cast<const int*>(kind), static_cast<const int*>(bank),
      static_cast<const int*>(row), static_cast<const int*>(delta),
      static_cast<const int*>(dep), static_cast<const int8_t*>(weak),
      static_cast<const int*>(tables), static_cast<const int*>(costs),
      static_cast<int*>(t_issue), static_cast<int*>(t_resp),
      static_cast<int*>(stats), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// The fast instantiation: queue <= SCAN_MAX_Q, banks <= SCAN_MAX_BANKS,
// table <= REPRO_VM_MAX_L (the wrapper picks it by shape).
extern "C" int slot_scan_launch(const int* params, const void* kind,
                                const void* bank, const void* row,
                                const void* delta, const void* dep,
                                const void* weak, const void* tables,
                                const void* costs, void* t_issue,
                                void* t_resp, void* stats, void* stream) {
  const ScanParams p = read_params(params);
  if (p.batch <= 0) return 0;
  slot_scan_kernel<<<p.batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(kind), static_cast<const int*>(bank),
      static_cast<const int*>(row), static_cast<const int*>(delta),
      static_cast<const int*>(dep), static_cast<const int8_t*>(weak),
      static_cast<const int*>(tables), static_cast<const int*>(costs),
      static_cast<int*>(t_issue), static_cast<int*>(t_resp),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}
