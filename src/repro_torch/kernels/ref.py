"""Plain PyTorch versions of the CUDA kernels.

They repeat the kernels' arithmetic with tensor ops, run on any device,
and are what the emulator and the LM use for CPU tensors. :func:`slot_scan_ref` is
a batched loop over slots that mirrors the reference slot body
(``repro.core.emulator._make_slot_body``) line for line, over a leading
batch axis of trace rows, carrying an
:class:`~repro_torch.core.state.EmulatorState`; :func:`ref_scan_ref` mirrors
the reference's pre-optimization engine (``_run_core_ref``) the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import dram, smcprog
from repro_torch.core.bloom import bloom_probe_torch
from repro_torch.core.dram import NOP, WRITE, at_index, set_index
from repro_torch.core.faults import (FaultModel, apply_slot,
                                     fault_result_fields, init_fault_state,
                                     para_bits)
from repro_torch.core.state import BIG, EmulatorState
from repro_torch.core.threefry import u32
from repro_torch.kernels.slot_scan import STAT_FIELDS, ScanParams

FP = 4096  # fixed-point denominator for tick<->cycle conversion


def bloom_probe_ref(words: torch.Tensor, keys: torch.Tensor, k: int,
                    m_bits: int) -> torch.Tensor:
    """words int32 ``[Bw, W]``, keys ``[B, N]`` -> int8 ``[B, N]``."""
    return bloom_probe_torch(words, m_bits, k, keys).to(torch.int8)


def policy_vm_ref(tables: torch.Tensor, envm: torch.Tensor) -> torch.Tensor:
    """tables ``[P, L + 1, 4]`` x env ``[N_LOADS, Q]`` -> ``[P, 3, Q]``."""
    return smcprog.evaluate_table(tables, envm)


# The decoded policy program, which the CUDA kernels build from a packed
# table once per launch (csrc/policy_vm.cuh, vm_decode) and run on every
# evaluation. A lane's values live in slots: the N_LOADS environment
# loads first, then a slot that always reads zero, then one slot per
# table row. A load row is no instruction: a reference to it reads its
# environment slot. A constant row (OP_CONST, and any opcode outside the
# set) is written once before the first evaluation. Only ALU rows that a
# header register reaches run, in table order, each a
# ``(op | dst << VM_DST_SHIFT, a, b, c)`` row of slots.
VM_ZERO = smcprog.N_LOADS          # the slot that reads zero
VM_ROW0 = smcprog.N_LOADS + 1      # the slot of table row 0
VM_DST_SHIFT = 5                   # opcodes are below 32


def vm_n_slots(L: int) -> int:
    return VM_ROW0 + L


@dataclasses.dataclass(frozen=True)
class DecodedTable:
    """One packed table, decoded (see :func:`decode_table`)."""
    prog: torch.Tensor      # int32 [n_exec, 4]: op | dst << 5, a, b, c
    consts: torch.Tensor    # int32 [n_const, 2]: slot, value
    score: int              # the slots the header registers read
    boost: int
    mitigate: int
    env_mask: int           # bit s: environment slot s is read
    n_slots: int


def decode_table(table) -> DecodedTable:
    """Decode one packed ``[L + 1, 4]`` table by the rules of
    ``smcprog.eval_table_rows`` / ``evaluate_table``:

    - an operand is clipped to ``[0, L)``; one at or past its own row
      reads zero (the reference reads rows not yet written as zero);
    - opcodes 1..12 load ``env[op - 1]``, 16..27 are ALU ops (NOT reads
      only ``a`` and becomes ``EQ(a, 0)``; SELECT reads ``imm`` as its
      third operand, clipped), any other opcode is the constant ``imm``;
    - the score register is clipped; a negative boost or mitigate
      register reads zero, tested before the clip;
    - a row no header register reaches, through ``a``, ``b`` and
      SELECT's ``imm``, is dropped.
    """
    t = torch.as_tensor(table, dtype=torch.int32).cpu().tolist()
    hdr, rows = t[0], t[1:]
    L = len(rows)
    if L < 1:
        raise ValueError("a table needs at least one row")

    def clip(x):
        return min(max(x, 0), L - 1)

    def is_load(op):
        return smcprog.OP_AGE <= op <= smcprog.OP_PARA_RAND

    def is_alu(op):
        return smcprog.OP_ADD <= op <= smcprog.OP_SELECT

    def operands(i):   # the rows row i reads (those below i)
        op, a, b, imm = rows[i]
        if not is_alu(op):
            return []
        refs = [clip(a)]
        if op != smcprog.OP_NOT:
            refs.append(clip(b))
        if op == smcprog.OP_SELECT:
            refs.append(clip(imm))
        return [r for r in refs if r < i]

    def slot_of(r):
        op = rows[r][0]
        return op - smcprog.OP_AGE if is_load(op) else VM_ROW0 + r

    def operand_slot(i, x):
        r = clip(x)
        return slot_of(r) if r < i else VM_ZERO

    live = [False] * L
    live[clip(hdr[1])] = True
    for reg in hdr[2:4]:
        if reg >= 0:
            live[clip(reg)] = True
    for i in reversed(range(L)):
        if live[i]:
            for r in operands(i):
                live[r] = True

    prog, consts, used = [], [], []
    for i, (op, a, b, imm) in enumerate(rows):
        if not live[i] or is_load(op):
            continue
        if not is_alu(op):
            consts.append((VM_ROW0 + i, imm))
            continue
        sa = operand_slot(i, a)
        sb = VM_ZERO if op == smcprog.OP_NOT else operand_slot(i, b)
        sc = operand_slot(i, imm) if op == smcprog.OP_SELECT else VM_ZERO
        code = smcprog.OP_EQ if op == smcprog.OP_NOT else op
        prog.append((code | (VM_ROW0 + i) << VM_DST_SHIFT, sa, sb, sc))
        used += [sa, sb, sc]

    def header_slot(reg, optional):
        return VM_ZERO if optional and reg < 0 else slot_of(clip(reg))

    score = header_slot(hdr[1], False)
    boost = header_slot(hdr[2], True)
    mitigate = header_slot(hdr[3], True)
    used += [score, boost, mitigate]
    env_mask = 0
    for s in used:
        if s < VM_ZERO:
            env_mask |= 1 << s
    return DecodedTable(
        prog=torch.tensor(prog, dtype=torch.int32).reshape(-1, 4),
        consts=torch.tensor(consts, dtype=torch.int32).reshape(-1, 2),
        score=score, boost=boost, mitigate=mitigate, env_mask=env_mask,
        n_slots=vm_n_slots(L))


def eval_decoded(dec: DecodedTable, envm: torch.Tensor) -> torch.Tensor:
    """A decoded program over ``[N_LOADS, Q]`` environments -> ``[3, Q]``
    int32 (score, boost, mitigate), as the kernels evaluate it."""
    q = envm.shape[-1]
    vals = torch.zeros((dec.n_slots, q), dtype=torch.int32)
    vals[:VM_ZERO] = envm.to(torch.int32).cpu()
    for slot, value in dec.consts.tolist():
        vals[slot] = value
    wrap = smcprog.wrap32
    for x, a, b, c in dec.prog.tolist():
        op, dst = x & ((1 << VM_DST_SHIFT) - 1), x >> VM_DST_SHIFT
        va, vb = vals[a], vals[b]
        if op == smcprog.OP_ADD:
            v = wrap(va.long() + vb.long())
        elif op == smcprog.OP_SUB:
            v = wrap(va.long() - vb.long())
        elif op == smcprog.OP_MUL:
            v = wrap(va.long() * vb.long())
        elif op == smcprog.OP_MIN:
            v = torch.minimum(va, vb)
        elif op == smcprog.OP_MAX:
            v = torch.maximum(va, vb)
        elif op == smcprog.OP_AND:
            v = va & vb
        elif op == smcprog.OP_OR:
            v = va | vb
        elif op == smcprog.OP_EQ:
            v = (va == vb).int()
        elif op == smcprog.OP_LT:
            v = (va < vb).int()
        elif op == smcprog.OP_GE:
            v = (va >= vb).int()
        elif op == smcprog.OP_SELECT:
            v = torch.where(va != 0, vb, vals[c])
        else:
            raise ValueError(f"decoded program holds opcode {op}")
        vals[dst] = v
    return torch.stack([vals[dec.score], vals[dec.boost],
                        vals[dec.mitigate]])


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


def selective_scan_ref(u, dt, Bm, Cm, A, D, h0):
    """The selective scan token by token, as the kernel runs it: ``h_t =
    exp(dt_t A) h_{t-1} + (dt_t u_t) B_t``, ``y_t = sum_n h_t C_t + D
    u_t``. Shapes as ``ops.selective_scan``; returns (y, hT) float32."""
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        d_t, u_t = dt[:, t], u[:, t]
        h = torch.exp(d_t[..., None] * A) * h \
            + (d_t * u_t)[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]) + u_t * D)
    y = torch.stack(ys, 1) if ys else torch.empty_like(u, dtype=torch.float32)
    return y, h


def _scatter_(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """In place: ``x[b, idx[b]] = val[b]`` for every batch row."""
    x.scatter_(1, idx.long().unsqueeze(1), val.to(x.dtype).unsqueeze(1))


def _mul_div(a, num, den):
    """Exact a * num // den (floor) without int32 overflow."""
    q = torch.div(a, den, rounding_mode="floor")
    r = a - q * den
    return q * num + torch.div(r * num, den, rounding_mode="floor")


def _issue_frontier(st: EmulatorState, kind, delta, dep, W: int,
                    upto: int, gate: Optional[torch.Tensor] = None) -> None:
    """Advance the in-order issue pointer by up to ``upto`` requests,
    pushing them into free queue slots; updates ``st`` in place.
    ``gate`` ``[B]`` (a stream window's freeze gate) ANDs into every
    advance."""
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
        if gate is not None:
            can = can & gate
        t_new = torch.maximum(torch.maximum(base, win_t), dep_t)
        _scatter_(st.t_issue, jc,
                  torch.where(can, t_new, at_index(st.t_issue, jc)))
        _scatter_(st.t_resp, jc,
                  torch.where(can & is_nop, t_new, at_index(st.t_resp, jc)))
        _scatter_(st.queue, slot,
                  torch.where(can & ~is_nop, jc, at_index(st.queue, slot)))
        st.ptr = torch.where(can, st.ptr + 1, st.ptr)


def _policy_env(q_t, q_bank, q_row, is_write, visible, hit_now, ready,
                dram_now, last_bank, n_banks: int, hammer_ct,
                para_rand) -> torch.Tensor:
    """The ``[B, N_LOADS, Q]`` scheduling environment, rows in opcode
    order."""
    Q = q_t.shape[1]
    age_rel = q_t - torch.where(visible, q_t, BIG).amin(1, keepdim=True)
    bank_busy = (torch.gather(ready, 1, q_bank.long())
                 > dram_now.unsqueeze(1)).int()
    rr_dist = torch.remainder(q_bank - last_bank.unsqueeze(1) - 1, n_banks)
    qslot = torch.arange(Q, dtype=torch.int32,
                         device=q_t.device).expand_as(q_t)
    wp = (visible & is_write).int().sum(1, keepdim=True).int().expand_as(q_t)
    rows = [q_t, age_rel, hit_now.int(), q_bank, q_row, is_write.int(),
            bank_busy, rr_dist, qslot, wp, hammer_ct, para_rand]
    return torch.stack([r.to(torch.int32) for r in rows], dim=1)


def _decide(st: EmulatorState, kind, qidx, q_t, q_bank, q_row, visible,
            tables: Optional[torch.Tensor], p: ScanParams, fm: bool, kp,
            para: bool):
    """The slot's scheduling decision, shared by both engines' slot bodies
    as the reference shares ``_policy_env`` and ``select_slot_table``: the
    queue lane ``[B]`` to serve and the policy's mitigate flag for it (None
    for the legacy flag). ``fm``: a fault model (``hammer_ct`` loads its
    counters); ``para``: ``para_rand`` draws under ``kp``, else loads 0."""
    hit_now = torch.gather(st.bank["open_row"], 1, q_bank.long()) == q_row
    if tables is not None:
        is_write = torch.gather(kind, 1, qidx) == WRITE
        zero = torch.zeros_like(q_t)
        hct = torch.gather(st.faults["hct"], 1, q_bank.long()) if fm \
            else zero
        pr = para_bits(kp, q_bank, q_row, st.dram_now) if para else zero
        envm = _policy_env(q_t, q_bank, q_row, is_write, visible,
                           hit_now, st.bank["ready"], st.dram_now,
                           st.last_bank, p.n_banks, hct, pr)
        out = smcprog.evaluate_table(tables, envm)
        qslot = smcprog.select_slot_table(out[:, 0], out[:, 1], visible)
        return qslot, at_index(out[:, 2], qslot) != 0
    key_all = torch.where(visible, q_t, BIG)
    key_hit = torch.where(visible & hit_now, q_t, BIG)
    slot_hit = torch.argmin(key_hit, dim=1)
    slot_old = torch.argmin(key_all, dim=1)
    use_hit = (visible & hit_now).any(1) & bool(p.frfcfs)
    return torch.where(use_hit, slot_hit, slot_old), None


# the issue frontier's advances per slot (the reference's _FRONTIER_UPTO):
# a stream window's slot runs only while ptr <= n - FRONTIER_UPTO
FRONTIER_UPTO = 4


def _group_consts(tables: Optional[torch.Tensor], costs: torch.Tensor,
                  p: ScanParams):
    """A group's constants, shared by both engines' slot bodies: the DRAM
    timing, the decision's SMC counter increment, MC issue interval and
    visibility slack ``[B]`` (from the cost pairs and the mode), the
    divisor of the tick conversion, the fault model and its stream keys
    (None without one), the PARA key, and whether ``para_rand`` draws."""
    t = dram.Timing(tRCD=p.tRCD, tRCD_reduced=p.tRCD_reduced, tCL=p.tCL,
                    tRP=p.tRP, tRAS=p.tRAS, tWR=p.tWR, tBL=p.tBL,
                    tRFC=p.tRFC, tREFI=p.tREFI, tRC_CLONE=p.tRC_CLONE)
    counter_inc = costs[:, 0]
    smc_lat = costs[:, 1]
    mc_issue = smc_lat if p.nots else torch.full_like(smc_lat, p.mc_issue_ts)
    vis_slack = smc_lat if p.nots else torch.zeros_like(smc_lat)
    den = max(p.scale_num, 1)
    if p.victim_slots < 0 or (p.victim_slots > 0 and not p.faults):
        raise ValueError(f"slot_scan: a fault model (victim_slots "
                         f"{p.victim_slots}) runs with faults=1")
    fm = keys = None
    if p.victim_slots > 0:   # the seed enters only through the keys
        fm = FaultModel(hammer_threshold=p.hammer_threshold,
                        hammer_flip_fp=p.hammer_flip_fp, weak_fp=p.weak_fp,
                        retention_ticks=p.retention_ticks,
                        victim_slots=p.victim_slots)
        keys = ((u32(p.kh0), u32(p.kh1)), (u32(p.kw0), u32(p.kw1)))
    kp = (u32(p.kp0), u32(p.kp1))
    # para_rand is drawn on the fault path only (p.faults, which the
    # engine sets for a table that loads it), and only for tables that
    # load it; elsewhere it loads 0, as in every kernel instantiation
    para = bool(p.faults) and tables is not None and bool(
        (tables[:, 1:, 0] == smcprog.OP_PARA_RAND).any())
    return t, counter_inc, mc_issue, vis_slack, den, fm, keys, kp, para


def _slot_body(kind, bank, row, delta, dep, weak: Optional[torch.Tensor],
               tables: Optional[torch.Tensor], costs: torch.Tensor,
               p: ScanParams):
    """The per-slot transition over one group's trace arrays, as a
    function ``step(st, live)`` that advances ``st`` in place by one slot
    (``repro.core.emulator._make_slot_body``). ``live`` is None, or the
    stream window's freeze gate ``[B]``, evaluated at the start of the
    slot: it ANDs into every frontier advance, into the service and into
    the idle hop, so a gated-off row's slot is the identity. With a fault
    model (``p.victim_slots > 0``) every served slot advances its carry
    (``core.faults.apply_slot``) after the DRAM service. Returns ``step``
    and the fault model (None without one)."""
    N = kind.shape[1]
    W = p.window
    t, counter_inc, mc_issue, vis_slack, den, fm, keys, kp, para = \
        _group_consts(tables, costs, p)

    def step(st: EmulatorState, live: Optional[torch.Tensor]) -> None:
        _issue_frontier(st, kind, delta, dep, W, upto=FRONTIER_UPTO,
                        gate=live)

        # gather queued requests (O(Q), not O(N))
        qvalid = st.queue >= 0
        qidx = st.queue.clamp(0, N - 1).long()
        q_t = torch.where(qvalid, torch.gather(st.t_issue, 1, qidx), BIG)
        q_bank = torch.gather(bank, 1, qidx)
        q_row = torch.gather(row, 1, qidx)

        cutoff = st.mc_release + vis_slack
        visible = qvalid & (q_t <= cutoff.unsqueeze(1))
        do = visible.any(1)
        if live is not None:
            do = do & live

        # ---- scheduling decision (two-level argmin, ties to lane 0..)
        qslot, mit = _decide(st, kind, qidx, q_t, q_bank, q_row, visible,
                             tables, p, fm is not None, kp, para)
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

        refreshed = do & (nbs["refs_done"] != st.bank["refs_done"])
        # the transition differs from the old state only at bank b and
        # in the channel scalars, so a per-row select merges it
        st.bank = {k: torch.where(do.view(-1, *([1] * (v.dim() - 1))),
                                  nbs[k], v)
                   for k, v in st.bank.items()}
        if fm is not None:
            # the fault carry, and a fired mitigation's ticks on bank b
            st.faults, extra = apply_slot(
                fm, p.n_rows, p.tREFI, p.mit_ticks, st.faults, do=do,
                hit=hit, bank=b, row=at_index(row, pick),
                kind=at_index(kind, pick), t_start=dram_req_t,
                refreshed=refreshed, mitigate=mit, keys=keys)
            _scatter_(st.bank["ready"], b,
                      at_index(st.bank["ready"], b) + extra)
        _scatter_(st.t_resp, pick,
                  torch.where(do, resp_t, at_index(st.t_resp, pick)))
        _scatter_(st.queue, qslot,
                  torch.where(do, -1, at_index(st.queue, qslot)))
        # MC busy until the next decision slot; idle hop to the next
        # arrival when nothing is visible, never on an empty queue (and
        # never in a frozen slot)
        nxt = q_t.amin(1)
        may_hop = qvalid.any(1)
        if live is not None:
            may_hop = may_hop & live
        idle = torch.where(may_hop,
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

    return step, fm


def slot_scan_ref(kind, bank, row, delta, dep, weak: Optional[torch.Tensor],
                  tables: Optional[torch.Tensor], costs: torch.Tensor,
                  p: ScanParams) -> dict:
    """Plain version of ``slot_scan_cuda``: same inputs, same outputs.
    A fresh state through ``p.slots`` slots of :func:`_slot_body`, then
    the trailing frontier pass."""
    B, N = kind.shape
    dev = kind.device
    W = p.window
    step, fm = _slot_body(kind, bank, row, delta, dep, weak, tables, costs, p)
    st = EmulatorState.fresh(N, p.n_banks, p.q, batch=B, device=dev)
    if fm is not None:
        st.faults = init_fault_state(fm, p.n_banks, B, dev)
    for _ in range(p.slots):
        step(st, None)

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
    if fm is not None:
        out.update(fault_result_fields(st.faults))
    return out


def slot_scan_window_ref(st: EmulatorState, kind, bank, row, delta, dep,
                         weak: Optional[torch.Tensor],
                         tables: Optional[torch.Tensor], costs: torch.Tensor,
                         p: ScanParams, final: bool) -> EmulatorState:
    """Plain version of ``slot_scan_window_cuda``: one stream window's scan
    (``repro.core.emulator._stream_step_core`` after its shift) of the
    shifted window state ``st`` over the window's trace arrays ``[B, n]``,
    for ``p.slots`` slots of :func:`_slot_body` under the freeze gate
    ``final | ptr <= n - FRONTIER_UPTO``, with no trailing pass. Returns
    the new state (``st`` is left as it was). It stops once every row is
    frozen or drained: each later slot would be the identity."""
    N = kind.shape[1]
    step, _ = _slot_body(kind, bank, row, delta, dep, weak, tables, costs, p)
    st = dataclasses.replace(
        st, **{f.name: _clone(getattr(st, f.name))
               for f in dataclasses.fields(st)})
    for _ in range(p.slots):
        live = (st.ptr <= N - FRONTIER_UPTO) | bool(final)
        drained = (st.ptr >= N) & (st.queue < 0).all(1)
        if not bool((live & ~drained).any()):
            break
        step(st, live)
    return st


def _clone(v):
    return {k: x.clone() for k, x in v.items()} if isinstance(v, dict) \
        else v.clone()


# ---------------------------------------------------------------------------
# The reference engine (``repro.core.emulator._run_core_ref``): the
# pre-optimization slot scan behind run_ref / run_ref_many, the plain version
# of csrc/ref_scan.cu. Every state update is a full-length select, as the
# reference writes it; the Bloom probe of the picked request runs inside the
# slot; the budget is the uniform 2 * n + 4 (``p.slots``).
# ---------------------------------------------------------------------------


def _issue_frontier_ref(st: EmulatorState, kind, delta, dep, W: int,
                        upto: int) -> None:
    """``_issue_frontier_ref``: up to ``upto`` in-order advances, each
    update a full-length select over the row's arrays; updates ``st`` in
    place."""
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
        st.t_issue = torch.where(can.unsqueeze(1),
                                 set_index(st.t_issue, jc, t_new), st.t_issue)
        st.t_resp = torch.where((can & is_nop).unsqueeze(1),
                                set_index(st.t_resp, jc, t_new), st.t_resp)
        st.queue = torch.where((can & ~is_nop).unsqueeze(1),
                               set_index(st.queue, slot, jc), st.queue)
        st.ptr = torch.where(can, st.ptr + 1, st.ptr)


def ref_scan_ref(kind, bank, row, delta, dep, bloom: Optional[tuple],
                 tables: Optional[torch.Tensor], costs: torch.Tensor,
                 p: ScanParams) -> dict:
    """Plain version of ``ref_scan_cuda``: trace arrays ``[B, N]`` int32,
    ``bloom`` None or (words ``[1 or B, W]`` int32, k, m_bits), ``tables``
    ``[B, L + 1, 4]`` int32 or None, ``costs`` ``[B, 2]`` int32. A fresh
    state through ``p.slots`` slots of the reference's body, then the
    trailing frontier pass (only its t_issue kept); the outputs of
    :func:`slot_scan_ref`."""
    B, N = kind.shape
    dev = kind.device
    W = p.window
    t, counter_inc, mc_issue, vis_slack, den, fm, keys, kp, para = \
        _group_consts(tables, costs, p)
    st = EmulatorState.fresh(N, p.n_banks, p.q, batch=B, device=dev)
    if fm is not None:
        st.faults = init_fault_state(fm, p.n_banks, B, dev)
    for _ in range(p.slots):
        _issue_frontier_ref(st, kind, delta, dep, W, upto=FRONTIER_UPTO)

        qvalid = st.queue >= 0
        qidx = st.queue.clamp(0, N - 1).long()
        q_t = torch.where(qvalid, torch.gather(st.t_issue, 1, qidx), BIG)
        q_bank = torch.gather(bank, 1, qidx)
        q_row = torch.gather(row, 1, qidx)

        cutoff = st.mc_release + vis_slack
        visible = qvalid & (q_t <= cutoff.unsqueeze(1))
        do = visible.any(1)

        qslot, mit = _decide(st, kind, qidx, q_t, q_bank, q_row, visible,
                             tables, p, fm is not None, kp, para)
        pick = at_index(qidx, qslot)

        decision_t = torch.maximum(at_index(st.t_issue, pick), st.mc_release)
        dram_req_t = torch.maximum(st.dram_now,
                                   _mul_div(decision_t, FP, den))
        trcd_eff = torch.full_like(decision_t, t.tRCD)
        b = at_index(bank, pick)
        r = at_index(row, pick)
        if bloom is not None:
            words, k, m_bits = bloom
            gid = b.long() * p.n_rows + r.long()
            weakp = bloom_probe_torch(words, m_bits, k, gid.unsqueeze(1))[:, 0]
            trcd_eff = torch.where(weakp, t.tRCD, t.tRCD_reduced).int()
        nbs, t_done, hit = dram.service_request(
            st.bank, t, at_index(kind, pick), b, r, dram_req_t, trcd_eff)

        resp_t = _mul_div(t_done, p.scale_num, FP) + p.mc_lat
        resp_t = torch.maximum(resp_t, decision_t + mc_issue)

        old_refs = st.bank["refs_done"]
        st.bank = {k: torch.where(do.view(-1, *([1] * (v.dim() - 1))),
                                  nbs[k], v)
                   for k, v in st.bank.items()}
        if fm is not None:
            st.faults, extra = apply_slot(
                fm, p.n_rows, p.tREFI, p.mit_ticks, st.faults, do=do,
                hit=hit, bank=b, row=r, kind=at_index(kind, pick),
                t_start=dram_req_t,
                refreshed=do & (nbs["refs_done"] != old_refs),
                mitigate=mit, keys=keys)
            st.bank["ready"] = set_index(st.bank["ready"], b,
                                         at_index(st.bank["ready"], b)
                                         + extra)
        st.t_resp = torch.where(do.unsqueeze(1),
                                set_index(st.t_resp, pick, resp_t), st.t_resp)
        st.queue = torch.where(do.unsqueeze(1),
                               set_index(st.queue, qslot,
                                         torch.full_like(qslot, -1)),
                               st.queue)
        st.dram_now = torch.where(do, torch.maximum(st.dram_now, dram_req_t),
                                  st.dram_now)
        st.hits = st.hits + (do & hit).int()
        st.served_n = st.served_n + do.int()
        st.smc_fpga_cycles = st.smc_fpga_cycles + torch.where(
            do, counter_inc, 0)
        st.last_bank = torch.where(do, b, st.last_bank)
        # the idle hop, never on an empty queue
        nxt = q_t.amin(1)
        idle = torch.where(qvalid.any(1),
                           torch.maximum(st.mc_release,
                                         torch.clamp(nxt, max=BIG - 1)),
                           st.mc_release)
        st.mc_release = torch.where(
            do, torch.maximum(st.mc_release, decision_t + mc_issue), idle)

    t_resp = st.t_resp.clone()
    _issue_frontier_ref(st, kind, delta, dep, W, upto=8)
    valid = kind != NOP
    last_resp = torch.where(valid & (t_resp < BIG), t_resp, 0).amax(1)
    last_issue = torch.where(valid, st.t_issue, 0).amax(1)
    vals = (torch.maximum(last_resp, last_issue), st.hits, st.served_n,
            st.dram_now, st.smc_fpga_cycles)
    out = {f: v.to(torch.int32) for f, v in zip(STAT_FIELDS, vals)}
    out["t_resp"] = t_resp
    out["t_issue"] = st.t_issue
    if fm is not None:
        out.update(fault_result_fields(st.faults))
    return out
