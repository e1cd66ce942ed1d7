// The emulator's slot scan: one thread runs one trace row of a batch
// group through the whole slot budget.
//
// Replaces the lax.scan over _make_slot_body in
// src/repro/core/emulator.py (_run_core, the scan at line 531), which
// XLA runs as ~100 tiny ops per slot; as separate GPU launches that
// would be one launch per op per slot.
//
// What bounds it on the H100: each slot depends on the one before (the
// MC counter, the DRAM frontier, the bank state), so a row is a serial
// chain of `slots` steps, each a few hundred dependent integer ops and
// cached loads. Bytes (the five trace arrays, the weak flags, the two
// tag arrays) and total operations are far below the card's rates; the
// floor is slots x the latency of one step, whatever the batch.
// Design: one block of one thread per row (rows on different SMs, no
// warp divergence between rows); the hardware queue (Q = max(window, 2))
// and the per-bank state live in registers / local memory, the policy
// table in shared memory; t_issue / t_resp live in global memory because
// the issue frontier reads them at data-dependent distances (window and
// dep). The Bloom probe is not in the loop: its key depends only on the
// request, so the wrapper probes every request once (bloom_probe kernel)
// and this kernel reads one int8 flag per served request. The scheduling
// decision runs the policy VM body of policy_vm.cuh on every visible
// lane; without a table the legacy FR-FCFS / FCFS flag decides.
//
// Bit-exactness with the reference: int32 wraparound via common.cuh,
// floor division / modulo as in numpy, argmin / first-free ties to the
// first lane (strict '<' scans).
#include <cuda_runtime.h>

#include "common.cuh"
#include "policy_vm.cuh"

#define SCAN_MAX_Q 64
#define SCAN_MAX_BANKS 64

namespace {

constexpr int kFP = 4096;
constexpr int kWrite = 1;
constexpr int kRcCopy = 2;
constexpr int kRcInit = 3;
constexpr int kNop = 4;

// Host parameter block, in this order (see slot_scan.py).
struct ScanParams {
  int batch, n, window, q, slots, n_banks, n_rows;
  int scale_num, mc_lat, mc_issue_ts, nots, frfcfs, table_len, use_weak;
  int tRCD, tRCD_reduced, tCL, tRP, tRAS, tWR, tBL, tRFC, tREFI, tRC_CLONE;
};
constexpr int kNumParams = sizeof(ScanParams) / sizeof(int);

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Exact a * num // den without int32 overflow for the engine's ranges.
__device__ __forceinline__ int mul_div(int a, int num, int den) {
  const int q = floordiv(a, den);
  const int r = wsub(a, wmul(q, den));
  return wadd(wmul(q, num), floordiv(wmul(r, num), den));
}

// The trailing frontier pass computes t_resp of NOPs it resolves but the
// reference discards them (only its t_issue is kept): a shadow holds
// those writes so later advances of the same pass still see them.
struct RespShadow {
  int idx[8];
  int val[8];
  int count;
};

template <bool kShadow>
__device__ __forceinline__ int read_resp(const int* tr, int i,
                                         const RespShadow& sh) {
  if (kShadow) {
    for (int s = sh.count - 1; s >= 0; --s)
      if (sh.idx[s] == i) return sh.val[s];
  }
  return tr[i];
}

// In-order issue of up to `upto` requests into free queue lanes
// (emulator.py _issue_frontier). A disabled advance leaves every input
// as it was, so the loop stops at the first one.
template <bool kShadow>
__device__ void issue_frontier(const ScanParams& p, const int* kind,
                               const int* delta, const int* dep, int* ti,
                               int* tr, int* queue, int& ptr, int upto,
                               RespShadow& sh) {
  const int n = p.n;
  for (int u = 0; u < upto; ++u) {
    const int j = ptr;
    const int jc = clampi(j, 0, n - 1);
    const int prev_issue = j > 0 ? ti[clampi(j - 1, 0, n - 1)] : 0;
    const int base = wadd(prev_issue, delta[jc]);
    const int wj = j - p.window;
    const int tw = read_resp<kShadow>(tr, clampi(wj, 0, n - 1), sh);
    const bool win_known = (wj < 0) || (tw < REPRO_BIG);
    const int win_t = wj >= 0 ? wadd(tw, 1) : 0;
    const int dpj = dep[jc];
    const int dj = wsub(j, dpj);
    const bool dep_on = dpj > 0;
    const int td = read_resp<kShadow>(tr, clampi(dj, 0, n - 1), sh);
    const bool dep_known = !dep_on || dj < 0 || td < REPRO_BIG;
    const int dep_t = (dep_on && dj >= 0) ? wadd(td, 1) : 0;
    int slot = -1;
    for (int q = 0; q < p.q; ++q)
      if (slot < 0 && queue[q] < 0) slot = q;
    const bool is_nop = kind[jc] == kNop;
    const bool can = (j < n) && win_known && dep_known && (slot >= 0 || is_nop);
    if (!can) return;
    const int t_new = imax(imax(base, win_t), dep_t);
    ti[jc] = t_new;
    if (is_nop) {
      if (kShadow) {
        sh.idx[sh.count] = jc;
        sh.val[sh.count] = t_new;
        ++sh.count;
      } else {
        tr[jc] = t_new;
      }
    } else {
      queue[slot] = jc;
    }
    ++ptr;
  }
}

__global__ void slot_scan_kernel(ScanParams p, const int* __restrict__ kinds,
                                 const int* __restrict__ banks,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ deltas,
                                 const int* __restrict__ deps,
                                 const int8_t* __restrict__ weak_all,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ costs,
                                 int* __restrict__ t_issue,
                                 int* __restrict__ t_resp,
                                 int* __restrict__ stats) {
  extern __shared__ int s_table[];
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

  const int L = p.table_len;
  if (L > 0) {
    const int n_tab = (L + 1) * 4;
    for (int i = 0; i < n_tab; ++i)
      s_table[i] = tables[static_cast<size_t>(b) * n_tab + i];
  }
  const int counter_inc = costs[2 * b];
  const int smc_lat = costs[2 * b + 1];
  const int mc_issue = p.nots ? smc_lat : p.mc_issue_ts;
  const int vis_slack = p.nots ? smc_lat : 0;
  const int den = imax(p.scale_num, 1);

  int queue[SCAN_MAX_Q];
  for (int q = 0; q < p.q; ++q) queue[q] = -1;
  int open_row[SCAN_MAX_BANKS], ready[SCAN_MAX_BANKS], act_at[SCAN_MAX_BANKS];
  for (int i = 0; i < p.n_banks; ++i) {
    open_row[i] = -1;
    ready[i] = 0;
    act_at[i] = 0;
  }
  int bus_busy = 0, refs_done = 0;
  int ptr = 0, mc_release = 0, dram_now = 0, hits = 0, served = 0, smc = 0;
  int last_bank = -1;

  int q_t[SCAN_MAX_Q], q_idx[SCAN_MAX_Q];
  bool q_vis[SCAN_MAX_Q];
  int vals[REPRO_VM_MAX_L];
  int env[REPRO_N_LOADS];
  RespShadow sh;
  sh.count = 0;

  for (int s = 0; s < p.slots; ++s) {
    issue_frontier<false>(p, kind, delta, dep, ti, tr, queue, ptr, 4, sh);

    const int cutoff = wadd(mc_release, vis_slack);
    bool any_valid = false, do_serve = false;
    int nxt = REPRO_BIG;
    for (int q = 0; q < p.q; ++q) {
      const bool valid = queue[q] >= 0;
      const int qi = clampi(queue[q], 0, p.n - 1);
      const int t = valid ? ti[qi] : REPRO_BIG;
      q_idx[q] = qi;
      q_t[q] = t;
      q_vis[q] = valid && t <= cutoff;
      any_valid = any_valid || valid;
      do_serve = do_serve || q_vis[q];
      nxt = imin(nxt, t);
    }
    if (!do_serve) {
      // idle hop to the next arrival, never on an empty queue
      if (any_valid) mc_release = imax(mc_release, imin(nxt, REPRO_BIG - 1));
      continue;
    }

    // ---- scheduling decision: two-level argmin over every lane's key
    // (BIG for invisible lanes), ties to the first lane
    int qslot = 0;
    if (L > 0) {
      int min_vis = REPRO_BIG, write_pressure = 0;
      for (int q = 0; q < p.q; ++q) {
        if (!q_vis[q]) continue;
        min_vis = imin(min_vis, q_t[q]);
        write_pressure += kind[q_idx[q]] == kWrite ? 1 : 0;
      }
      int best_all = 0, best_boost = 0, slot_boost = 0;
      bool any_boost = false;
      for (int q = 0; q < p.q; ++q) {
        int key_all = REPRO_BIG, key_boost = REPRO_BIG;
        if (q_vis[q]) {
          const int qb = bank[q_idx[q]];
          const int qr = row[q_idx[q]];
          env[0] = q_t[q];                                 // age
          env[1] = wsub(q_t[q], min_vis);                  // age_rel
          env[2] = open_row[qb] == qr ? 1 : 0;             // row_hit
          env[3] = qb;                                     // bank
          env[4] = qr;                                     // row
          env[5] = kind[q_idx[q]] == kWrite ? 1 : 0;       // is_write
          env[6] = ready[qb] > dram_now ? 1 : 0;           // bank_busy
          env[7] = floormod(wsub(wsub(qb, last_bank), 1), p.n_banks);  // rr_dist
          env[8] = q;                                      // qslot
          env[9] = write_pressure;                         // write_pressure
          env[10] = 0;                                     // hammer_ct
          env[11] = 0;                                     // para_rand
          int score, boost, mit;
          policy_vm_lane(s_table, L, env, vals, &score, &boost, &mit);
          key_all = imin(score, REPRO_BIG - 1);
          if (boost != 0) {
            key_boost = key_all;
            any_boost = true;
          }
        }
        if (q == 0 || key_all < best_all) {
          best_all = key_all;
          qslot = q;
        }
        if (q == 0 || key_boost < best_boost) {
          best_boost = key_boost;
          slot_boost = q;
        }
      }
      if (any_boost) qslot = slot_boost;
    } else {
      int best_all = 0, best_hit = 0, slot_hit = 0;
      bool any_hit = false;
      for (int q = 0; q < p.q; ++q) {
        int key_all = REPRO_BIG, key_hit = REPRO_BIG;
        if (q_vis[q]) {
          key_all = q_t[q];
          if (open_row[bank[q_idx[q]]] == row[q_idx[q]]) {
            key_hit = q_t[q];
            any_hit = true;
          }
        }
        if (q == 0 || key_all < best_all) {
          best_all = key_all;
          qslot = q;
        }
        if (q == 0 || key_hit < best_hit) {
          best_hit = key_hit;
          slot_hit = q;
        }
      }
      if (p.frfcfs && any_hit) qslot = slot_hit;
    }
    const int pick = q_idx[qslot];

    // ---- DRAM service (dram.py service_request)
    const int decision_t = imax(ti[pick], mc_release);
    const int now = imax(dram_now, mul_div(decision_t, kFP, den));
    const int trcd = (weak != nullptr && weak[pick] == 0) ? p.tRCD_reduced
                                                         : p.tRCD;
    const int kd = kind[pick];
    const int bk = bank[pick];
    const int rw = row[pick];
    const int refs_due = imax(wsub(floordiv(now, p.tREFI), refs_done), 0);
    const int start = wadd(imax(now, ready[bk]), wmul(refs_due, p.tRFC));
    const bool is_rc = kd == kRcCopy || kd == kRcInit;
    const bool is_hit = open_row[bk] == rw && !is_rc;
    const bool is_closed = open_row[bk] < 0;
    const int pre_at = imax(start, wadd(act_at[bk], p.tRAS));
    const int act_start = is_closed ? start : wadd(pre_at, p.tRP);
    const int col_start = is_hit ? start : wadd(act_start, trcd);
    const int data_start = imax(wadd(col_start, p.tCL), bus_busy);
    const int data_done = wadd(data_start, p.tBL);
    const int rc_done = wadd(act_start, p.tRC_CLONE);
    const int t_done = is_rc ? rc_done : data_done;
    const int bank_next =
        is_rc ? rc_done : (kd == kWrite ? wadd(data_done, p.tWR) : data_done);
    if (!is_hit) act_at[bk] = act_start;
    open_row[bk] = rw;
    ready[bk] = bank_next;
    if (!is_rc) bus_busy = data_done;
    refs_done = wadd(refs_done, refs_due);

    // ---- time scaling: response consume-tag in modeled proc cycles
    const int resp_t = imax(wadd(mul_div(t_done, p.scale_num, kFP), p.mc_lat),
                            wadd(decision_t, mc_issue));
    tr[pick] = resp_t;
    queue[qslot] = -1;
    mc_release = imax(mc_release, wadd(decision_t, mc_issue));
    dram_now = imax(dram_now, now);
    hits += is_hit ? 1 : 0;
    served += 1;
    smc = wadd(smc, counter_inc);
    last_bank = bk;
  }

  // trailing frontier pass so post-memory compute counts
  issue_frontier<true>(p, kind, delta, dep, ti, tr, queue, ptr, 8, sh);

  int last_resp = 0, last_issue = 0;
  for (int i = 0; i < p.n; ++i) {
    if (kind[i] == kNop) continue;
    const int r = tr[i];
    if (r < REPRO_BIG) last_resp = imax(last_resp, r);
    last_issue = imax(last_issue, ti[i]);
  }
  int* st = stats + 5 * b;
  st[0] = imax(last_resp, last_issue);
  st[1] = hits;
  st[2] = served;
  st[3] = dram_now;
  st[4] = smc;
}

}  // namespace

extern "C" int slot_scan_num_params() { return kNumParams; }

extern "C" int slot_scan_launch(const int* params, const void* kind,
                                const void* bank, const void* row,
                                const void* delta, const void* dep,
                                const void* weak, const void* tables,
                                const void* costs, void* t_issue,
                                void* t_resp, void* stats, void* stream) {
  ScanParams p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kNumParams; ++i) dst[i] = params[i];
  if (p.batch <= 0) return 0;
  const size_t smem =
      p.table_len > 0 ? static_cast<size_t>(p.table_len + 1) * 4 * sizeof(int)
                      : 0;
  slot_scan_kernel<<<p.batch, 1, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(kind), static_cast<const int*>(bank),
      static_cast<const int*>(row), static_cast<const int*>(delta),
      static_cast<const int*>(dep), static_cast<const int8_t*>(weak),
      static_cast<const int*>(tables), static_cast<const int*>(costs),
      static_cast<int*>(t_issue), static_cast<int*>(t_resp),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}
