"""Plain PyTorch versions of the CUDA kernels.

They repeat the kernels' arithmetic with tensor ops, run on any device,
and are what the emulator and the LM use for CPU tensors. :func:`slot_scan_ref` is
a batched loop over slots that mirrors the reference slot body
(``repro.core.emulator._make_slot_body``) line for line, over a leading
batch axis of trace rows, carrying an
:class:`~repro_torch.core.state.EmulatorState`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dram, smcprog
from repro_torch.core.bloom import bloom_probe_torch
from repro_torch.core.dram import NOP, WRITE, at_index
from repro_torch.core.state import BIG, EmulatorState
from repro_torch.kernels.slot_scan import STAT_FIELDS, ScanParams

FP = 4096  # fixed-point denominator for tick<->cycle conversion


def bloom_probe_ref(words: torch.Tensor, keys: torch.Tensor, k: int,
                    m_bits: int) -> torch.Tensor:
    """words int32 ``[Bw, W]``, keys ``[B, N]`` -> int8 ``[B, N]``."""
    return bloom_probe_torch(words, m_bits, k, keys).to(torch.int8)


def policy_vm_ref(tables: torch.Tensor, envm: torch.Tensor) -> torch.Tensor:
    """tables ``[P, L + 1, 4]`` x env ``[N_LOADS, Q]`` -> ``[P, 3, Q]``."""
    return smcprog.evaluate_table(tables, envm)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q ``[BHq, Sq, hd]``, k / v ``[BHkv, Sk, hd]`` (GQA by ratio: q row i
    reads kv row ``i // G``) -> ``[BHq, Sq, hd]`` in q's dtype. Float32
    softmax; the causal mask is the oracle's ``tril(k=Sk-Sq)``."""
    BH, Sq, hd = q.shape
    BK, Sk, _ = k.shape
    G = BH // BK
    qf = q.float() * (hd ** -0.5)
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    s = torch.einsum("bqd,bkd->bqk", qf, kf)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = torch.where(mask[None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def rowclone_copy_ref(x: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A copy of ``x`` ``[R, C]``, into ``out`` (any row stride) when given."""
    if out is None:
        return x.clone()
    return out.copy_(x)


def _scatter_(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """In place: ``x[b, idx[b]] = val[b]`` for every batch row."""
    x.scatter_(1, idx.long().unsqueeze(1), val.to(x.dtype).unsqueeze(1))


def _mul_div(a, num, den):
    """Exact a * num // den (floor) without int32 overflow."""
    q = torch.div(a, den, rounding_mode="floor")
    r = a - q * den
    return q * num + torch.div(r * num, den, rounding_mode="floor")


def _issue_frontier(st: EmulatorState, kind, delta, dep, W: int,
                    upto: int) -> None:
    """Advance the in-order issue pointer by up to ``upto`` requests,
    pushing them into free queue slots; updates ``st`` in place."""
    N = kind.shape[1]
    for _ in range(upto):
        j = st.ptr
        jc = j.clamp(0, N - 1)
        prev_issue = torch.where(
            j > 0, at_index(st.t_issue, (j - 1).clamp(0, N - 1)), 0)
        base = prev_issue + at_index(delta, jc)
        wj = j - W
        tw = at_index(st.t_resp, wj.clamp(0, N - 1))
        win_known = (wj < 0) | (tw < BIG)
        win_t = torch.where(wj >= 0, tw + 1, 0)
        dpj = at_index(dep, jc)
        dj = j - dpj
        dep_on = dpj > 0
        td = at_index(st.t_resp, dj.clamp(0, N - 1))
        dep_known = ~dep_on | (dj < 0) | (td < BIG)
        dep_t = torch.where(dep_on & (dj >= 0), td + 1, 0)
        free = st.queue < 0
        slot = torch.argmax(free.int(), dim=1)
        is_nop = at_index(kind, jc) == NOP
        can = (j < N) & win_known & dep_known & (free.any(1) | is_nop)
        t_new = torch.maximum(torch.maximum(base, win_t), dep_t)
        _scatter_(st.t_issue, jc,
                  torch.where(can, t_new, at_index(st.t_issue, jc)))
        _scatter_(st.t_resp, jc,
                  torch.where(can & is_nop, t_new, at_index(st.t_resp, jc)))
        _scatter_(st.queue, slot,
                  torch.where(can & ~is_nop, jc, at_index(st.queue, slot)))
        st.ptr = torch.where(can, st.ptr + 1, st.ptr)


def _policy_env(q_t, q_bank, q_row, is_write, visible, hit_now, ready,
                dram_now, last_bank, n_banks: int) -> torch.Tensor:
    """The ``[B, N_LOADS, Q]`` scheduling environment, rows in opcode
    order (``hammer_ct`` and ``para_rand`` are zero: no fault model)."""
    Q = q_t.shape[1]
    zero = torch.zeros_like(q_t)
    age_rel = q_t - torch.where(visible, q_t, BIG).amin(1, keepdim=True)
    bank_busy = (torch.gather(ready, 1, q_bank.long())
                 > dram_now.unsqueeze(1)).int()
    rr_dist = torch.remainder(q_bank - last_bank.unsqueeze(1) - 1, n_banks)
    qslot = torch.arange(Q, dtype=torch.int32,
                         device=q_t.device).expand_as(q_t)
    wp = (visible & is_write).int().sum(1, keepdim=True).int().expand_as(q_t)
    rows = [q_t, age_rel, hit_now.int(), q_bank, q_row, is_write.int(),
            bank_busy, rr_dist, qslot, wp, zero, zero]
    return torch.stack([r.to(torch.int32) for r in rows], dim=1)


def slot_scan_ref(kind, bank, row, delta, dep, weak: Optional[torch.Tensor],
                  tables: Optional[torch.Tensor], costs: torch.Tensor,
                  p: ScanParams) -> dict:
    """Plain version of ``slot_scan_cuda``: same inputs, same outputs."""
    B, N = kind.shape
    dev = kind.device
    W = p.window
    t = dram.Timing(tRCD=p.tRCD, tRCD_reduced=p.tRCD_reduced, tCL=p.tCL,
                    tRP=p.tRP, tRAS=p.tRAS, tWR=p.tWR, tBL=p.tBL,
                    tRFC=p.tRFC, tREFI=p.tREFI, tRC_CLONE=p.tRC_CLONE)
    counter_inc = costs[:, 0]
    smc_lat = costs[:, 1]
    mc_issue = smc_lat if p.nots else torch.full_like(smc_lat, p.mc_issue_ts)
    vis_slack = smc_lat if p.nots else torch.zeros_like(smc_lat)
    den = max(p.scale_num, 1)
    st = EmulatorState.fresh(N, p.n_banks, p.q, batch=B, device=dev)

    for _ in range(p.slots):
        _issue_frontier(st, kind, delta, dep, W, upto=4)

        # gather queued requests (O(Q), not O(N))
        qvalid = st.queue >= 0
        qidx = st.queue.clamp(0, N - 1).long()
        q_t = torch.where(qvalid, torch.gather(st.t_issue, 1, qidx), BIG)
        q_bank = torch.gather(bank, 1, qidx)
        q_row = torch.gather(row, 1, qidx)

        cutoff = st.mc_release + vis_slack
        visible = qvalid & (q_t <= cutoff.unsqueeze(1))
        do = visible.any(1)

        # ---- scheduling decision (two-level argmin, ties to lane 0..)
        hit_now = torch.gather(st.bank["open_row"], 1, q_bank.long()) == q_row
        if tables is not None:
            is_write = torch.gather(kind, 1, qidx) == WRITE
            envm = _policy_env(q_t, q_bank, q_row, is_write, visible,
                               hit_now, st.bank["ready"], st.dram_now,
                               st.last_bank, p.n_banks)
            out = smcprog.evaluate_table(tables, envm)
            qslot = smcprog.select_slot_table(out[:, 0], out[:, 1], visible)
        else:
            key_all = torch.where(visible, q_t, BIG)
            key_hit = torch.where(visible & hit_now, q_t, BIG)
            slot_hit = torch.argmin(key_hit, dim=1)
            slot_old = torch.argmin(key_all, dim=1)
            use_hit = (visible & hit_now).any(1) & bool(p.frfcfs)
            qslot = torch.where(use_hit, slot_hit, slot_old)
        pick = at_index(qidx, qslot)

        # ---- DRAM service (command-batch executor)
        decision_t = torch.maximum(at_index(st.t_issue, pick), st.mc_release)
        dram_req_t = torch.maximum(st.dram_now,
                                   _mul_div(decision_t, FP, den))
        trcd_eff = torch.full_like(decision_t, t.tRCD)
        if weak is not None:
            trcd_eff = torch.where(at_index(weak, pick) != 0, t.tRCD,
                                   t.tRCD_reduced).int()
        b = at_index(bank, pick)
        nbs, t_done, hit = dram.service_request(
            st.bank, t, at_index(kind, pick), b, at_index(row, pick),
            dram_req_t, trcd_eff)

        # ---- time scaling: response consume-tag in modeled proc cycles
        resp_t = _mul_div(t_done, p.scale_num, FP) + p.mc_lat
        resp_t = torch.maximum(resp_t, decision_t + mc_issue)

        # the transition differs from the old state only at bank b and
        # in the channel scalars, so a per-row select merges it
        st.bank = {k: torch.where(do.view(-1, *([1] * (v.dim() - 1))),
                                  nbs[k], v)
                   for k, v in st.bank.items()}
        _scatter_(st.t_resp, pick,
                  torch.where(do, resp_t, at_index(st.t_resp, pick)))
        _scatter_(st.queue, qslot,
                  torch.where(do, -1, at_index(st.queue, qslot)))
        # MC busy until the next decision slot; idle hop to the next
        # arrival when nothing is visible, never on an empty queue
        nxt = q_t.amin(1)
        idle = torch.where(qvalid.any(1),
                           torch.maximum(st.mc_release,
                                         torch.clamp(nxt, max=BIG - 1)),
                           st.mc_release)
        st.mc_release = torch.where(
            do, torch.maximum(st.mc_release, decision_t + mc_issue), idle)
        st.dram_now = torch.where(do, torch.maximum(st.dram_now, dram_req_t),
                                  st.dram_now)
        st.hits = st.hits + (do & hit).int()
        st.served_n = st.served_n + do.int()
        st.smc_fpga_cycles = st.smc_fpga_cycles + torch.where(
            do, counter_inc, 0)
        st.last_bank = torch.where(do, b, st.last_bank)

    # trailing frontier pass so post-memory compute counts; only its
    # t_issue is kept
    t_resp = st.t_resp.clone()
    _issue_frontier(st, kind, delta, dep, W, upto=8)
    valid = kind != NOP
    served_mask = t_resp < BIG
    last_resp = torch.where(valid & served_mask, t_resp, 0).amax(1)
    last_issue = torch.where(valid, st.t_issue, 0).amax(1)
    vals = (torch.maximum(last_resp, last_issue), st.hits, st.served_n,
            st.dram_now, st.smc_fpga_cycles)
    out = {f: v.to(torch.int32) for f, v in zip(STAT_FIELDS, vals)}
    out["t_resp"] = t_resp
    out["t_issue"] = st.t_issue
    return out
