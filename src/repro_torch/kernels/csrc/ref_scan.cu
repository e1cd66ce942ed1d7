// The reference engine's slot scan: one thread runs one trace row of a
// batch group through the uniform budget of 2 * n + 4 slots.
//
// Replaces the lax.scan of _run_core_ref in src/repro/core/emulator.py
// (the scan at line 735): the pre-optimization engine behind run_ref /
// run_ref_many, whose results the fast engine (slot_scan.cu) must equal.
// It is an engine of its own, so that run == run_ref catches the fast
// scan's optimizations going wrong: it shares no row body with
// slot_scan.cu and keeps none of its optimizations. Every slot runs the
// whole body as the reference writes it, in the reference's order:
//
//   the issue frontier (up to 4 advances), a pass over the queue lanes
//   (issue time, bank, row, visibility, row hit), the decision (the
//   legacy FR-FCFS / FCFS argmins, or the packed policy table interpreted
//   row by row for each lane), the Bloom probe of the picked request, the
//   DRAM service, the fault hook, and the counter advance or idle hop;
//
// then a trailing frontier pass of up to 8 advances, of which only
// t_issue is kept (the t_resp it gives NOPs is restored).
//
// There is no exact slot budget, no stop for a drained row, no Bloom or
// retention flag probed ahead of the scan and no queue, trace or table
// staged on chip. A row's state lives in global memory (its region of
// the scratch: the queue, the bank state, the aggressor counters and the
// VM's row values), read and written by one thread, so one kernel takes
// every shape the reference takes: any window, bank count and table
// length. What bounds it: each slot depends on the one before, and one
// thread walks every lane and table row in turn, so a slot costs the sum
// of its dependent loads (L1 hits); rows run side by side, one block each.
//
// Shared with the other kernels: the int32 wraparound and floor division
// helpers (common.cuh), the Bloom hashes (bloom_hash.cuh) and threefry
// (threefry.cuh). The DRAM service, the fault hook and the VM are written
// here again, from core/dram.py, core/faults.py and smcprog.py.
//
// Exactness as in the reference: int32 wraparound through uint32, numpy
// floor division and modulo, the host-rounded scale_num, argmin and the
// first free lane with ties to the first lane (strict '<'), keys clamped
// at BIG. The plain version is kernels/ref.py ref_scan_ref.
#include <cuda_runtime.h>

#include "bloom_hash.cuh"
#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kFP = 4096;
constexpr int kRead = 0, kWrite = 1, kRcCopy = 2, kRcInit = 3, kNop = 4;
// smcprog.py opcodes: the twelve loads in environment order, the ALU
enum : int {
  kOpAge = 1, kOpAgeRel, kOpRowHit, kOpBank, kOpRow, kOpIsWrite,
  kOpBankBusy, kOpRrDist, kOpQslot, kOpWritePressure, kOpHammerCt,
  kOpParaRand,
  kOpAdd = 16, kOpSub, kOpMul, kOpMin, kOpMax, kOpAnd, kOpOr, kOpNot,
  kOpEq, kOpLt, kOpGe, kOpSelect
};

// The host parameter block (kernels/slot_scan.py ScanParams), in order:
// the scan's scalars, then the fault path's.
struct ScanParams {
  int batch, n, window, q, slots, n_banks, n_rows;
  int scale_num, mc_lat, mc_issue_ts, nots, frfcfs, table_len, use_weak;
  int tRCD, tRCD_reduced, tCL, tRP, tRAS, tWR, tBL, tRFC, tREFI, tRC_CLONE;
};
struct FaultParams {
  int faults, hammer_threshold, hammer_flip_fp, weak_fp, retention_ticks;
  int victim_slots, mit_ticks;
  int kh0, kh1, kw0, kw1, kp0, kp1;
};
constexpr int kNumParams =
    (sizeof(ScanParams) + sizeof(FaultParams)) / sizeof(int);

// One group's Bloom filter: words [rows][n_words] (rows 1: shared), k
// hashes over m_bits bits; words null without a filter.
struct Bloom {
  const unsigned* words;
  int rows, n_words, k, m_bits;
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// emulator.py _mul_div: a * num // den without int32 overflow.
__device__ __forceinline__ int mul_div(int a, int num, int den) {
  const int q = floordiv(a, den);
  const int r = wsub(a, wmul(q, den));
  return wadd(wmul(q, num), floordiv(wmul(r, num), den));
}

__device__ __forceinline__ uint2 key_of(int k0, int k1) {
  return make_uint2(static_cast<unsigned>(k0), static_cast<unsigned>(k1));
}

// The row's state in global memory: the queue (request indices, -1 free),
// the bank state, the aggressor counters and the VM's row values.
struct Row {
  int *queue, *open, *ready, *act, *hct, *vals;
};

// emulator.py _issue_frontier_ref: up to `upto` in-order advances of the
// issue pointer into the first free queue lanes. An advance that cannot
// happen leaves everything as it is, and so would every later one of the
// same call. With `saved`, the t_resp a NOP had before this call is kept
// there (index, value) for the trailing pass to restore.
__device__ void frontier(const ScanParams& p, int upto, int& ptr,
                         const int* __restrict__ kind,
                         const int* __restrict__ delta,
                         const int* __restrict__ dep, int* ti, int* tr,
                         int* queue, int2* saved, int& n_saved) {
  const int N = p.n, W = p.window, Q = p.q;
  for (int u = 0; u < upto; ++u) {
    const int j = ptr;
    const int jc = clampi(j, 0, N - 1);
    const int prev = j > 0 ? ti[clampi(j - 1, 0, N - 1)] : 0;
    const int base = wadd(prev, delta[jc]);
    const int wj = wsub(j, W);
    const int tw = tr[clampi(wj, 0, N - 1)];
    const bool win_known = wj < 0 || tw < REPRO_BIG;
    const int win_t = wj >= 0 ? wadd(tw, 1) : 0;
    const int dpj = dep[jc];
    const int dj = wsub(j, dpj);
    const bool dep_on = dpj > 0;
    const int td = tr[clampi(dj, 0, N - 1)];
    const bool dep_known = !dep_on || dj < 0 || td < REPRO_BIG;
    const int dep_t = dep_on && dj >= 0 ? wadd(td, 1) : 0;
    int slot = -1;
    for (int q = 0; q < Q && slot < 0; ++q)
      if (queue[q] < 0) slot = q;
    const bool is_nop = kind[jc] == kNop;
    if (!(j < N && win_known && dep_known && (slot >= 0 || is_nop))) return;
    const int t_new = imax(imax(base, win_t), dep_t);
    ti[jc] = t_new;
    if (is_nop) {
      if (saved != nullptr) saved[n_saved++] = make_int2(jc, tr[jc]);
      tr[jc] = t_new;
    } else {
      queue[slot] = jc;
    }
    ++ptr;
  }
}

__device__ __forceinline__ bool bloom_has(const Bloom& bf, int b,
                                          unsigned key) {
  const unsigned* w =
      bf.words + static_cast<size_t>(bf.rows == 1 ? 0 : b) * bf.n_words;
  const unsigned mask = static_cast<unsigned>(bf.m_bits) - 1u;
  for (int i = 0; i < bf.k; ++i) {
    const unsigned idx = bloom_index(key, i, mask);
    if (((w[idx >> 5] >> (idx & 31u)) & 1u) == 0u) return false;
  }
  return true;
}

// One lane's scheduling environment (emulator.py _policy_env), the loads
// a table row reads by opcode.
struct Env {
  int qt, age_min, hit, bank, row, is_write, busy, rr, qslot, wp, hct;
  bool para;       // para_rand draws (the fault path), else it loads 0
  uint2 kt;        // the decision's PARA key, fold_in(kp, dram_now)
};

__device__ __forceinline__ int env_load(const Env& e, int op) {
  switch (op) {
    case kOpAge: return e.qt;
    case kOpAgeRel: return wsub(e.qt, e.age_min);
    case kOpRowHit: return e.hit;
    case kOpBank: return e.bank;
    case kOpRow: return e.row;
    case kOpIsWrite: return e.is_write;
    case kOpBankBusy: return e.busy;
    case kOpRrDist: return e.rr;
    case kOpQslot: return e.qslot;
    case kOpWritePressure: return e.wp;
    case kOpHammerCt: return e.hct;
    default:   // kOpParaRand
      return e.para ? tf_u16(tf_fold_in(tf_fold_in(e.kt, e.bank), e.row))
                    : 0;
  }
}

// smcprog.py evaluate_table for one lane: the packed table's L rows in
// order, row i writing vals[i]; operands clipped to [0, L) read zero at or
// past their own row; ADD / SUB / MUL wrap. Returns (score, boost,
// mitigate); a negative boost or mitigate register reads zero.
__device__ int3 vm_lane(const int* __restrict__ table, int L, int* vals,
                        const Env& e) {
  const int4* rows = reinterpret_cast<const int4*>(table) + 1;
  for (int i = 0; i < L; ++i) {
    const int4 r = rows[i];
    const int ra = clampi(r.y, 0, L - 1), rb = clampi(r.z, 0, L - 1);
    const int rc = clampi(r.w, 0, L - 1);
    const int x = ra < i ? vals[ra] : 0, y = rb < i ? vals[rb] : 0;
    int v;
    switch (r.x) {
      case kOpAdd: v = wadd(x, y); break;
      case kOpSub: v = wsub(x, y); break;
      case kOpMul: v = wmul(x, y); break;
      case kOpMin: v = imin(x, y); break;
      case kOpMax: v = imax(x, y); break;
      case kOpAnd: v = x & y; break;
      case kOpOr: v = x | y; break;
      case kOpNot: v = x == 0 ? 1 : 0; break;
      case kOpEq: v = x == y ? 1 : 0; break;
      case kOpLt: v = x < y ? 1 : 0; break;
      case kOpGe: v = x >= y ? 1 : 0; break;
      case kOpSelect: v = x != 0 ? y : (rc < i ? vals[rc] : 0); break;
      default:
        v = r.x >= kOpAge && r.x <= kOpParaRand ? env_load(e, r.x) : r.w;
    }
    vals[i] = v;
  }
  const int4 h = reinterpret_cast<const int4*>(table)[0];
  return make_int3(vals[clampi(h.y, 0, L - 1)],
                   h.z >= 0 ? vals[clampi(h.z, 0, L - 1)] : 0,
                   h.w >= 0 ? vals[clampi(h.w, 0, L - 1)] : 0);
}

// A row's fault counters (faults.py): flips (vptr, the next log index),
// hammer and retention flips, fired mitigations.
struct Faults {
  int vptr, ham, ret, mits;
};

// One flip event into the victim log [3][V] (while vptr < V) and counts.
__device__ __forceinline__ void log_flip(Faults& fs, int* vlog, int V,
                                         int bk, int rw, int now,
                                         bool hammer) {
  if (fs.vptr < V) {
    vlog[fs.vptr] = bk;
    vlog[V + fs.vptr] = rw;
    vlog[2 * V + fs.vptr] = now;
  }
  fs.vptr = wadd(fs.vptr, 1);
  if (hammer)
    ++fs.ham;
  else
    ++fs.ret;
}

// faults.py apply_slot for a served slot: the request of kind k to bank
// bk, row rw, served from tick now, a row hit if hit; refreshed: the
// service caught up on all-bank REFs; mit: the decision's mitigate.
// Returns the extra ticks of a fired mitigation on the bank.
__device__ int fault_hook(const ScanParams& p, const FaultParams& f,
                          Faults& fs, Row& st, int* vlog, int k, int bk,
                          int rw, int now, bool hit, bool refreshed,
                          bool mit) {
  if (refreshed)
    for (int i = 0; i < p.n_banks; ++i) st.hct[i] = 0;
  if (f.hammer_threshold > 0) {
    const int cur = wadd(st.hct[bk], hit ? 0 : 1);
    const bool crossed = !hit && cur >= f.hammer_threshold;
    if (crossed) {
      const uint2 kt = tf_fold_in(tf_fold_in(key_of(f.kh0, f.kh1), bk), now);
      for (int off = -1; off <= 1; off += 2) {
        const int vr = wadd(rw, off);
        if (vr >= 0 && vr < p.n_rows &&
            tf_u16(tf_fold_in(kt, vr)) < f.hammer_flip_fp)
          log_flip(fs, vlog, f.victim_slots, bk, vr, now, true);
      }
    }
    st.hct[bk] = crossed || mit ? 0 : cur;
  }
  if (f.weak_fp > 0 && k == kRead &&
      tf_u16(tf_fold_in(tf_fold_in(key_of(f.kw0, f.kw1), bk), rw)) <
          f.weak_fp &&
      floormod(now, p.tREFI) >= f.retention_ticks)
    log_flip(fs, vlog, f.victim_slots, bk, rw, now, false);
  fs.mits += mit ? 1 : 0;
  return mit ? f.mit_ticks : 0;
}

__global__ void ref_scan_kernel(
    ScanParams p, FaultParams f, Bloom bf, const int* __restrict__ kind_,
    const int* __restrict__ bank_, const int* __restrict__ row_,
    const int* __restrict__ delta_, const int* __restrict__ dep_,
    const int* __restrict__ tables, const int* __restrict__ costs,
    int* t_issue, int* t_resp, int* stats, int* fstats, int* vlog_,
    int* scratch, long long row_ints) {
  const int b = blockIdx.x;
  const int N = p.n, Q = p.q, NB = p.n_banks, L = p.table_len;
  const size_t off = static_cast<size_t>(b) * N;
  const int *kind = kind_ + off, *bank = bank_ + off, *row = row_ + off;
  const int *delta = delta_ + off, *dep = dep_ + off;
  int* ti = t_issue + off;
  int* tr = t_resp + off;
  Row st;
  st.queue = scratch + static_cast<size_t>(b) * row_ints;
  st.open = st.queue + Q;
  st.ready = st.open + NB;
  st.act = st.ready + NB;
  st.hct = st.act + NB;
  st.vals = st.hct + NB;
  for (int q = 0; q < Q; ++q) st.queue[q] = -1;
  for (int i = 0; i < NB; ++i) {
    st.open[i] = -1;
    st.ready[i] = 0;
    st.act[i] = 0;
    st.hct[i] = 0;
  }
  const int* table =
      L > 0 ? tables + static_cast<size_t>(b) * (L + 1) * 4 : nullptr;
  const int V = f.victim_slots;
  int* vlog = V > 0 ? vlog_ + static_cast<size_t>(b) * 3 * V : nullptr;
  const int counter_inc = costs[2 * b], smc_lat = costs[2 * b + 1];
  const int mc_issue = p.nots ? smc_lat : p.mc_issue_ts;
  const int vis_slack = p.nots ? smc_lat : 0;
  const int den = imax(p.scale_num, 1);
  const uint2 kp = key_of(f.kp0, f.kp1);

  int ptr = 0, mc = 0, dram_now = 0, hits = 0, served = 0, smc = 0;
  int last_bank = -1, bus = 0, refs = 0;
  Faults fs{0, 0, 0, 0};
  int n_saved = 0;
  for (int s = 0; s < p.slots; ++s) {
    frontier(p, 4, ptr, kind, delta, dep, ti, tr, st.queue, nullptr,
             n_saved);

    // the queue lanes: visibility, the legacy argmins, the idle hop's
    // earliest issue, and the environment's reductions
    const int cutoff = wadd(mc, vis_slack);
    bool do_ = false, any_valid = false, any_hit = false;
    int slot_old = 0, key_old = 0, slot_hit = 0, key_hit = 0;
    int nxt = 0, age_min = REPRO_BIG, wp = 0;
    for (int q = 0; q < Q; ++q) {
      const int qv = st.queue[q];
      const bool valid = qv >= 0;
      const int qi = clampi(qv, 0, N - 1);
      const int qt = valid ? ti[qi] : REPRO_BIG;
      const bool vis = valid && qt <= cutoff;
      const bool hit = st.open[bank[qi]] == row[qi];
      const int ka = vis ? qt : REPRO_BIG;
      const int kh = vis && hit ? qt : REPRO_BIG;
      if (q == 0 || ka < key_old) { key_old = ka; slot_old = q; }
      if (q == 0 || kh < key_hit) { key_hit = kh; slot_hit = q; }
      nxt = q == 0 ? qt : imin(nxt, qt);
      do_ |= vis;
      any_valid |= valid;
      any_hit |= vis && hit;
      age_min = imin(age_min, ka);
      wp += vis && kind[qi] == kWrite ? 1 : 0;
    }

    // ---- the scheduling decision
    int qslot;
    bool mit = false;
    if (table != nullptr) {
      Env e;
      e.age_min = age_min;
      e.wp = wp;
      e.para = f.faults != 0;
      e.kt = tf_fold_in(kp, dram_now);
      int slot_all = 0, key_all = 0, slot_b = 0, key_b = 0;
      bool mit_all = false, mit_b = false, any_boost = false;
      for (int q = 0; q < Q; ++q) {
        const int qv = st.queue[q];
        const bool valid = qv >= 0;
        const int qi = clampi(qv, 0, N - 1);
        e.qt = valid ? ti[qi] : REPRO_BIG;
        e.bank = bank[qi];
        e.row = row[qi];
        e.hit = st.open[e.bank] == e.row ? 1 : 0;
        e.is_write = kind[qi] == kWrite ? 1 : 0;
        e.busy = st.ready[e.bank] > dram_now ? 1 : 0;
        e.rr = floormod(wsub(wsub(e.bank, last_bank), 1), NB);
        e.qslot = q;
        e.hct = V > 0 ? st.hct[e.bank] : 0;
        const bool vis = valid && e.qt <= cutoff;
        const int3 o = vm_lane(table, L, st.vals, e);
        const int score = imin(o.x, REPRO_BIG - 1);
        const int ka = vis ? score : REPRO_BIG;
        const bool bo = vis && o.y != 0;
        const int kb = bo ? score : REPRO_BIG;
        if (q == 0 || ka < key_all) {
          key_all = ka; slot_all = q; mit_all = o.z != 0;
        }
        if (q == 0 || kb < key_b) { key_b = kb; slot_b = q; mit_b = o.z != 0; }
        any_boost |= bo;
      }
      qslot = any_boost ? slot_b : slot_all;
      mit = any_boost ? mit_b : mit_all;
    } else {
      qslot = p.frfcfs && any_hit ? slot_hit : slot_old;
    }

    if (do_) {
      const int pick = clampi(st.queue[qslot], 0, N - 1);
      const int k = kind[pick], bk = bank[pick], rw = row[pick];
      // ---- DRAM service (dram.py service_request)
      const int decision_t = imax(ti[pick], mc);
      const int now = imax(dram_now, mul_div(decision_t, kFP, den));
      int trcd = p.tRCD;
      if (bf.words != nullptr) {
        const unsigned gid =
            static_cast<unsigned>(wadd(wmul(bk, p.n_rows), rw));
        trcd = bloom_has(bf, b, gid) ? p.tRCD : p.tRCD_reduced;
      }
      const int refs_due = imax(wsub(floordiv(now, p.tREFI), refs), 0);
      const int start =
          wadd(imax(now, st.ready[bk]), wmul(refs_due, p.tRFC));
      const bool is_rc = k == kRcCopy || k == kRcInit;
      const int o_row = st.open[bk];
      const bool hit = o_row == rw && !is_rc;
      const int pre_at = imax(start, wadd(st.act[bk], p.tRAS));
      const int act_start = o_row < 0 ? start : wadd(pre_at, p.tRP);
      const int col_start = hit ? start : wadd(act_start, trcd);
      const int data_done =
          wadd(imax(wadd(col_start, p.tCL), bus), p.tBL);
      const int rc_done = wadd(act_start, p.tRC_CLONE);
      const int t_done = is_rc ? rc_done : data_done;
      // ---- time scaling: the response's consume tag
      const int resp_t = imax(wadd(mul_div(t_done, p.scale_num, kFP),
                                   p.mc_lat),
                              wadd(decision_t, mc_issue));
      st.open[bk] = rw;
      st.ready[bk] = is_rc ? rc_done
                           : (k == kWrite ? wadd(data_done, p.tWR) : data_done);
      st.act[bk] = hit ? st.act[bk] : act_start;
      bus = is_rc ? bus : data_done;
      refs = wadd(refs, refs_due);
      if (V > 0)
        st.ready[bk] = wadd(st.ready[bk],
                            fault_hook(p, f, fs, st, vlog, k, bk, rw, now,
                                       hit, refs_due != 0, mit));
      tr[pick] = resp_t;
      st.queue[qslot] = -1;
      dram_now = imax(dram_now, now);
      hits += hit ? 1 : 0;
      served += 1;
      smc = wadd(smc, counter_inc);
      last_bank = bk;
      mc = imax(mc, wadd(decision_t, mc_issue));
    } else if (any_valid) {   // idle hop, never on an empty queue
      mc = imax(mc, imin(nxt, REPRO_BIG - 1));
    }
  }

  // the trailing frontier pass: only its t_issue is kept
  int2 saved[8];
  frontier(p, 8, ptr, kind, delta, dep, ti, tr, st.queue, saved, n_saved);
  for (int i = n_saved - 1; i >= 0; --i) tr[saved[i].x] = saved[i].y;
  int last_resp = 0, last_issue = 0;
  for (int i = 0; i < N; ++i) {
    const bool valid = kind[i] != kNop;
    const int r = tr[i];
    last_resp = i == 0 ? (valid && r < REPRO_BIG ? r : 0)
                       : imax(last_resp, valid && r < REPRO_BIG ? r : 0);
    last_issue = i == 0 ? (valid ? ti[i] : 0)
                        : imax(last_issue, valid ? ti[i] : 0);
  }
  int* out = stats + 5 * b;
  out[0] = imax(last_resp, last_issue);
  out[1] = hits;
  out[2] = served;
  out[3] = dram_now;
  out[4] = smc;
  if (V > 0) {
    int* fo = fstats + 4 * b;
    fo[0] = fs.vptr;
    fo[1] = fs.ham;
    fo[2] = fs.ret;
    fo[3] = fs.mits;
  }
}

}  // namespace

extern "C" int ref_scan_num_params() { return kNumParams; }

// The scratch ints one row's state takes: the queue, three bank arrays,
// the aggressor counters and the VM's row values.
extern "C" long long ref_scan_row_ints(int q, int n_banks, int table_len) {
  return static_cast<long long>(q) + 4LL * n_banks +
         (table_len > 0 ? table_len : 1);
}

extern "C" int ref_scan_launch(const int* params, const void* kind,
                               const void* bank, const void* row,
                               const void* delta, const void* dep,
                               const void* words, int words_rows,
                               int n_words, int bloom_k, int bloom_m,
                               const void* tables, const void* costs,
                               void* t_issue, void* t_resp, void* stats,
                               void* fstats, void* vlog, void* scratch,
                               void* stream) {
  ScanParams p;
  FaultParams f;
  int* dp = reinterpret_cast<int*>(&p);
  int* df = reinterpret_cast<int*>(&f);
  constexpr int np = sizeof(ScanParams) / sizeof(int);
  for (int i = 0; i < np; ++i) dp[i] = params[i];
  for (int i = np; i < kNumParams; ++i) df[i - np] = params[i];
  if (p.batch <= 0) return 0;
  if (scratch == nullptr || (p.table_len > 0 && tables == nullptr) ||
      (f.victim_slots > 0 && (fstats == nullptr || vlog == nullptr)) ||
      (words != nullptr && (bloom_k < 1 || bloom_k > 8 || bloom_m < 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bloom bf{static_cast<const unsigned*>(words), words_rows, n_words,
                 bloom_k, bloom_m};
  const long long row_ints = ref_scan_row_ints(p.q, p.n_banks, p.table_len);
  ref_scan_kernel<<<p.batch, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      p, f, bf, static_cast<const int*>(kind), static_cast<const int*>(bank),
      static_cast<const int*>(row), static_cast<const int*>(delta),
      static_cast<const int*>(dep), static_cast<const int*>(tables),
      static_cast<const int*>(costs), static_cast<int*>(t_issue),
      static_cast<int*>(t_resp), static_cast<int*>(stats),
      static_cast<int*>(fstats), static_cast<int*>(vlog),
      static_cast<int*>(scratch), row_ints);
  return static_cast<int>(cudaGetLastError());
}
