"""The EasyDRAM engine: trace-driven, multi-domain, time-scaled emulation.

One slot scan implements the whole request lifetime: processor issue
(bounded-window in-order front end) -> hardware request buffer -> SMC
critical mode (visibility cutoff on the time-scaling counter) ->
scheduling decision -> command-batch execution on the bank state machine
-> response tagged with its consume cycle -> counter advance. Every slot
serves one visible request or idle-hops to the next arrival. All
arithmetic is exact int32 (DRAM ticks, processor cycles, a fixed-point
1/4096 conversion), so results are bit-reproducible: ``ts`` and
``reference`` coincide exactly, which is the paper's time-scaling claim.

The scheduling decision is, per batch row, the legacy ``sys.scheduler``
flag (FR-FCFS / FCFS), a staged ``sys.policy`` program, or a runtime
policy table (:func:`run_policies`, ``run_many(policies=...)``); staged
and runtime programs both run through the packed-table VM, the staged
one with ``sys``'s decision cost.

Execution: :func:`run_many` groups traces by (length bucket, mode,
policy-table bucket), pads each group to its bucket and its batch to a
power of two with all-NOP rows, and runs each group as one batch:

* on a CUDA device, one launch of the ``bloom_probe`` kernel flags every
  request of the group against its Bloom filter (the probe key depends
  only on the request), then one launch of the ``slot_scan`` kernel
  runs every row through the exact slot budget;
* on the CPU (``device="cpu"``), the plain PyTorch versions of both.

Entry points take ``device=None``, meaning ``"cuda"``; without a CUDA
device they raise rather than run on the CPU unasked.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import smcprog
from repro_torch.core.bloom import words_tensor
from repro_torch.core.dram import NOP
from repro_torch.core.smcprog import wrap32
from repro_torch.core.state import BIG, EmulatorState
from repro_torch.core.timescale import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import FP
from repro_torch.kernels.slot_scan import ScanParams

__all__ = ["BIG", "FP", "EmulatorState", "Trace", "pad_trace",
           "slot_budget", "group_key", "resolve_device", "run", "run_many",
           "run_policies"]


@dataclasses.dataclass
class Trace:
    """Padded request trace. kind==NOP entries are ignored."""
    kind: np.ndarray    # int32 [N]
    bank: np.ndarray    # int32 [N]
    row: np.ndarray     # int32 [N]
    delta: np.ndarray   # int32 [N] proc cycles of compute before this request
    dep: np.ndarray     # int32 [N] 0 = window-only; d>0 = depends on resp[i-d]

    @property
    def n(self):
        return int(self.kind.shape[0])

    @property
    def n_real(self):
        """Non-NOP request count — input to :func:`slot_budget`."""
        return int((np.asarray(self.kind) != NOP).sum())

    @staticmethod
    def of(kind, bank, row, delta, dep=None):
        kind = np.asarray(kind, np.int32)
        z = np.zeros_like(kind)
        return Trace(kind=kind, bank=np.asarray(bank, np.int32),
                     row=np.asarray(row, np.int32),
                     delta=np.asarray(delta, np.int32),
                     dep=z if dep is None else np.asarray(dep, np.int32))


def pad_trace(tr: Trace, n: int) -> Trace:
    """Pad with NOPs to length n."""
    k = n - tr.n
    if k < 0:
        raise ValueError(
            f"cannot pad a trace of length {tr.n} down to {n}: the "
            f"target must be >= the trace length")
    z = np.zeros(k, np.int32)
    return Trace(kind=np.concatenate([tr.kind, z + NOP]),
                 bank=np.concatenate([tr.bank, z]),
                 row=np.concatenate([tr.row, z]),
                 delta=np.concatenate([tr.delta, z]),
                 dep=np.concatenate([tr.dep, z]))


def _bucket(n: int) -> int:
    b = 32
    while b < n:
        b *= 2
    return b


def slot_budget(bucket: int, n_real: int) -> int:
    """Exact slot budget for a group padded to ``bucket`` whose largest
    trace has ``n_real`` non-NOP requests: ``2 * Rq + ceil((bucket - Rq)
    / 4) + 4`` with Rq = n_real rounded up to a ``max(bucket // 4, 8)``
    granule. Real requests take at most 2 slots (idle hop + serve), NOPs
    resolve 4 per slot in the frontier; surplus slots are no-ops."""
    g = max(bucket // 4, 8)
    rq = min(bucket, -(-n_real // g) * g)
    return 2 * rq + (bucket - rq + 3) // 4 + 4


def _batch_bucket(b: int) -> int:
    """Pad the batch axis to a power of two (filler rows are all-NOP)."""
    p = 1
    while p < b:
        p *= 2
    return p


def check_mode(mode: str) -> str:
    if mode not in ("ts", "nots", "reference"):
        raise ValueError(
            f"mode must be one of ('ts', 'nots', 'reference'), got {mode!r}")
    return mode


def _norm_mode(mode: str) -> str:
    """'reference' runs the exact 'ts' arithmetic — that coincidence IS
    the time-scaling claim — so they share one group."""
    return "ts" if mode == "reference" else mode


def _check_modes(modes: Sequence[str], n: int) -> List[str]:
    modes = list(modes)
    if len(modes) != n:
        raise ValueError(
            f"per-trace modes ({len(modes)}) must match len(traces) ({n})")
    for m in modes:
        check_mode(m)
    return modes


def _is_bloom_triple(b) -> bool:
    """One (words_u32, k, m_bits) filter, as opposed to a sequence."""
    return (len(b) == 3 and not isinstance(b[0], (tuple, list))
            and np.ndim(b[1]) == 0 and np.ndim(b[2]) == 0)


def _bloom_shape(blooms) -> Optional[tuple]:
    if blooms is None:
        return None
    if _is_bloom_triple(blooms):
        return ("shared", int(np.asarray(blooms[0]).shape[0]),
                blooms[1], blooms[2])
    b0 = tuple(blooms[0])
    return ("stacked", int(np.asarray(b0[0]).shape[0]), b0[1], b0[2])


def _normalize_blooms(blooms, n: int):
    """None | one shared triple | a per-trace list of same-shaped triples."""
    if blooms is None:
        return None
    blooms = list(blooms)
    if _is_bloom_triple(blooms):
        return tuple(blooms)
    blooms = [tuple(b) for b in blooms]
    if len(blooms) != n:
        raise ValueError(
            f"per-trace blooms ({len(blooms)}) must match len(traces) ({n})")
    b0 = blooms[0]
    if not all(_is_bloom_triple(b) and b[1] == b0[1] and b[2] == b0[2]
               and np.asarray(b[0]).shape == np.asarray(b0[0]).shape
               for b in blooms):
        raise ValueError(
            "per-trace blooms must share (words-shape, k, m_bits); use "
            "Campaign to mix bloom/no-bloom points in one grid")
    return blooms


def _policy_rt_sys(sys: SystemConfig) -> SystemConfig:
    """Scrub the fields a runtime policy table makes dead from the key."""
    return dataclasses.replace(sys, policy=None, scheduler="frfcfs",
                               smc_cycles_per_decision=0)


def _policy_cost_pair(sys: SystemConfig, cpd: int) -> tuple:
    """``(counter_inc, smc_latency_proc)`` for decision cost ``cpd``, with
    the config's own Python float rounding."""
    csys = dataclasses.replace(sys, smc_cycles_per_decision=int(cpd))
    return (int(cpd) + int(sys.smc_transfer_cycles),
            int(csys.smc_latency_fpga_proc))


def group_key(n: int, sys: SystemConfig, mode: str, blooms,
              policy=None) -> tuple:
    """Grouping key of one trace-length-n point (used by Campaign)."""
    if policy is None:
        return (_bucket(n), sys, _norm_mode(mode), _bloom_shape(blooms))
    return (_bucket(n), _policy_rt_sys(sys), _norm_mode(mode),
            _bloom_shape(blooms),
            ("policy", smcprog.table_bucket(policy.n_ops)))


def _check_program(p: smcprog.PolicyProgram) -> None:
    if p.uses(smcprog.OP_PARA_RAND):
        raise NotImplementedError(
            f"policy {p.name!r} loads para_rand, a fault-model draw: "
            f"ROADMAP Queue A 7")


def _normalize_policies(policies, policy_costs, sys: SystemConfig, n: int):
    """None, or (programs, smc_cycles_per_decision per trace row)."""
    if policies is None:
        if policy_costs is not None:
            raise ValueError("policy_costs requires policies")
        return None
    policies = list(policies)
    if len(policies) != n:
        raise ValueError(
            f"per-trace policies ({len(policies)}) must match "
            f"len(traces) ({n})")
    for p in policies:
        if not isinstance(p, smcprog.PolicyProgram):
            raise TypeError(
                f"policies must be smcprog.PolicyProgram, got "
                f"{type(p).__name__}")
        p.validate()
    if policy_costs is None:
        costs = [int(sys.smc_cycles_per_decision)] * n
    else:
        costs = [int(c) for c in policy_costs]
        if len(costs) != n:
            raise ValueError(
                f"per-trace policy_costs ({len(costs)}) must match "
                f"len(traces) ({n})")
    return policies, costs


def _scan_params(sys: SystemConfig, mode: str, batch: int, n: int,
                 slots: int, table_len: int, use_weak: bool) -> ScanParams:
    """One group's host scalars, computed exactly as the reference does
    (Python float rounding, never device float)."""
    t = sys.timing
    scale_num = int(round((sys.proc_per_tick_fpga if mode == "nots"
                           else sys.proc_per_tick_emu) * FP))
    return ScanParams(
        batch=batch, n=n, window=sys.window, q=max(sys.window, 2),
        slots=slots, n_banks=sys.geometry.n_banks,
        n_rows=sys.geometry.n_rows, scale_num=scale_num,
        mc_lat=0 if mode == "nots" else sys.hwmc_latency_proc,
        mc_issue_ts=sys.hwmc_issue_proc, nots=int(mode == "nots"),
        frfcfs=int(sys.scheduler == "frfcfs"), table_len=table_len,
        use_weak=int(use_weak), tRCD=t.tRCD, tRCD_reduced=t.tRCD_reduced,
        tCL=t.tCL, tRP=t.tRP, tRAS=t.tRAS, tWR=t.tWR, tBL=t.tBL,
        tRFC=t.tRFC, tREFI=t.tREFI, tRC_CLONE=t.tRC_CLONE)


def _finalize(out_row: dict, padded: Trace, sys: SystemConfig,
              mode: str) -> dict:
    """Per-trace derived metrics, computed on the host from the ints."""
    out = {kk: np.asarray(v) for kk, v in out_row.items()}
    out["exec_seconds"] = sys.cycles_to_seconds(out["exec_cycles"], mode)
    out["mode"] = mode
    out["n_requests"] = int((padded.kind != NOP).sum())
    lat = out["t_resp"] - out["t_issue"]
    ok = (padded.kind != NOP) & (out["t_resp"] < BIG)
    out["avg_load_latency_cycles"] = float(lat[ok].mean()) if ok.any() else 0.0
    return out


def _run_group(traces, idxs, bucket, gmode, lb, sys, modes, blooms, pol,
               device, results) -> None:
    """Pad, stack and run one (bucket, mode, table-bucket) group."""
    geo = sys.geometry
    padded = [pad_trace(traces[i], bucket) for i in idxs]
    bb = _batch_bucket(len(idxs))
    if bb > len(idxs):  # all-NOP filler rows, discarded below
        filler = Trace.of(np.full(bucket, NOP), np.zeros(bucket),
                          np.zeros(bucket), np.zeros(bucket))
        padded += [filler] * (bb - len(idxs))
    stacked = {f: np.stack([getattr(p, f) for p in padded])
               for f in ("kind", "bank", "row", "delta", "dep")}
    if stacked["bank"].min() < 0 or stacked["bank"].max() >= geo.n_banks:
        raise ValueError(f"trace banks must lie in [0, {geo.n_banks})")
    kind, bank, row, delta, dep = (
        torch.from_numpy(stacked[f]).to(device)
        for f in ("kind", "bank", "row", "delta", "dep"))

    weak = None
    if blooms is not None:
        if isinstance(blooms, tuple):
            words = words_tensor(blooms[0], device).unsqueeze(0)
            k, m_bits = int(blooms[1]), int(blooms[2])
        else:
            rows_w = [np.asarray(blooms[i][0]) for i in idxs]
            rows_w += [rows_w[0]] * (bb - len(idxs))
            words = words_tensor(np.stack(rows_w), device)
            k, m_bits = int(blooms[0][1]), int(blooms[0][2])
        keys = wrap32(bank.long() * geo.n_rows + row.long())
        weak = ops.bloom_probe(words.contiguous(), keys, k, m_bits)

    if lb is not None:       # runtime policy tables, one per row
        progs = [pol[0][i] for i in idxs]
        cost_rows = [_policy_cost_pair(sys, pol[1][i]) for i in idxs]
    elif sys.policy is not None:   # staged program: same table, sys cost
        progs = [sys.policy] * len(idxs)
        cost_rows = [_policy_cost_pair(sys, sys.smc_cycles_per_decision)]
        lb = smcprog.table_bucket(sys.policy.n_ops)
    else:                    # legacy scheduler flag
        progs = None
        cost_rows = [_policy_cost_pair(sys, sys.smc_cycles_per_decision)]
    cost_rows = cost_rows + [cost_rows[0]] * (bb - len(cost_rows))
    costs = torch.tensor(cost_rows, dtype=torch.int32, device=device)
    tables = None
    if progs is not None:
        for p in progs:
            _check_program(p)
        packed = [smcprog.pack_program(p, lb) for p in progs]
        packed += [packed[0]] * (bb - len(packed))
        tables = torch.from_numpy(np.stack(packed)).to(device)

    slots = slot_budget(bucket, max(traces[i].n_real for i in idxs))
    p = _scan_params(sys, gmode, bb, bucket, slots,
                     0 if tables is None else lb, weak is not None)
    out = ops.slot_scan(kind, bank, row, delta, dep, weak, tables, costs, p)
    host = {kk: v.cpu().numpy() for kk, v in out.items()}
    for j, i in enumerate(idxs):
        results[i] = _finalize({kk: v[j] for kk, v in host.items()},
                               padded[j], sys, modes[i])


def run_many(traces: Sequence[Trace], sys: SystemConfig,
             mode: Union[str, Sequence[str]] = "ts", blooms=None,
             policies=None, policy_costs=None, device=None) -> List[dict]:
    """Evaluate many traces under one ``SystemConfig`` in batched groups.

    ``mode`` is 'ts' | 'nots' | 'reference' or one per trace. ``blooms``
    is None, one shared ``(words, k, m_bits)`` filter or one per trace.
    ``policies`` / ``policy_costs`` give one program (and its
    ``smc_cycles_per_decision``, default ``sys``'s) per trace row.
    Returns one result dict per trace, in input order."""
    if sys.faults is not None:
        raise NotImplementedError("fault injection: ROADMAP Queue A 7")
    dev = resolve_device(device)
    traces = list(traces)
    n = len(traces)
    modes = _check_modes([mode] * n if isinstance(mode, str) else mode, n)
    blooms = _normalize_blooms(blooms, n)
    pol = _normalize_policies(policies, policy_costs, sys, n)
    groups: dict = {}
    for i, tr in enumerate(traces):
        lb = None if pol is None else smcprog.table_bucket(pol[0][i].n_ops)
        groups.setdefault(
            (_bucket(tr.n), _norm_mode(modes[i]), lb), []).append(i)
    results: List[Optional[dict]] = [None] * n
    for (bucket, gmode, lb), idxs in groups.items():
        _run_group(traces, idxs, bucket, gmode, lb, sys, modes, blooms, pol,
                   dev, results)
    return results


def run_policies(trace: Trace, sys: SystemConfig,
                 programs: Sequence[smcprog.PolicyProgram],
                 mode: str = "ts", bloom: Optional[tuple] = None,
                 derive_cost: bool = True, device=None) -> List[dict]:
    """One trace under many programs, one program per batch row.
    ``derive_cost`` charges each program ``prog.smc_cycles()`` (the
    ``sys.with_policy`` semantics), else ``sys``'s cost."""
    programs = list(programs)
    costs = ([p.smc_cycles() for p in programs] if derive_cost
             else [sys.smc_cycles_per_decision] * len(programs))
    return run_many([trace] * len(programs), sys, mode=mode, blooms=bloom,
                    policies=programs, policy_costs=costs, device=device)


def run(trace: Trace, sys: SystemConfig, mode: str = "ts",
        bloom: Optional[tuple] = None, device=None) -> dict:
    """One trace, one config, one mode (a batch of one).
    ``bloom``: (words_u32, k, m_bits)."""
    return run_many([trace], sys, mode=mode, blooms=bloom, device=device)[0]
