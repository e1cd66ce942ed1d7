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
one with ``sys``'s decision cost. A fault model (``sys.faults``,
``core.faults``) advances its carry on every served slot of the same
scan; a policy's ``mitigate`` output charges a neighbour refresh.

Execution: :func:`run_many` groups traces by (length bucket, mode,
policy-table bucket), pads each group to its bucket and its batch to a
power of two with all-NOP rows, and runs each group as one batch:

* on a CUDA device, one launch of the ``bloom_probe`` kernel flags every
  request of the group against its Bloom filter (the probe key depends
  only on the request), then one launch of the ``slot_scan`` kernel
  runs every row through the exact slot budget;
* on the CPU (``device="cpu"``), the plain PyTorch versions of both.

:func:`run_stream` / :func:`run_stream_many` take traces too long to
materialize, in constant-memory windows (the section at the end): one
launch of the ``slot_scan`` kernel's window entry per window, with
results equal to :func:`run_many`'s.

Entry points take ``device=None``, meaning ``"cuda"``; without a CUDA
device they raise rather than run on the CPU unasked.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import smcprog
from repro_torch.core.bloom import words_tensor
from repro_torch.core.dram import NOP, neighbor_refresh_ticks
from repro_torch.core.faults import (DOMAIN_HAMMER, DOMAIN_PARA,
                                     DOMAIN_WEAK, domain_key,
                                     fault_result_fields)
from repro_torch.core.smcprog import wrap32
from repro_torch.core.state import (BIG, TRACE_FIELDS, EmulatorState,
                                    StreamState)
from repro_torch.core.threefry import as_int32
from repro_torch.core.timescale import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import FP, FRONTIER_UPTO
from repro_torch.kernels.slot_scan import ScanParams

__all__ = ["BIG", "FP", "EmulatorState", "Trace", "pad_trace",
           "slot_budget", "group_key", "resolve_device", "run", "run_many",
           "run_policies", "StreamState", "DEFAULT_STREAM_CHUNK",
           "DEFAULT_STREAM_DEP", "stream_halo", "stream_slot_budget",
           "shift_window", "run_stream", "run_stream_many"]


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


def _fault_params(sys: SystemConfig, para: bool) -> dict:
    """The fault model's scan scalars and its threefry stream keys (as
    int32 bit patterns); ``para``: a table loads ``para_rand``, which
    draws under seed 0 without a fault model."""
    fm = sys.faults
    if fm is None:
        return {"faults": int(para)}
    kh, kw, kp = (domain_key(fm.seed, d)
                  for d in (DOMAIN_HAMMER, DOMAIN_WEAK, DOMAIN_PARA))
    return dict(faults=1, hammer_threshold=fm.hammer_threshold,
                hammer_flip_fp=fm.hammer_flip_fp, weak_fp=fm.weak_fp,
                retention_ticks=fm.retention_ticks,
                victim_slots=fm.victim_slots,
                mit_ticks=neighbor_refresh_ticks(sys.timing),
                **{f"{nm}{i}": as_int32(k[i])
                   for nm, k in (("kh", kh), ("kw", kw), ("kp", kp))
                   for i in (0, 1)})


def _scan_params(sys: SystemConfig, mode: str, batch: int, n: int,
                 slots: int, table_len: int, use_weak: bool,
                 para: bool = False) -> ScanParams:
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
        tRFC=t.tRFC, tREFI=t.tREFI, tRC_CLONE=t.tRC_CLONE,
        **_fault_params(sys, para))


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
    if "flips" in out:   # a fault model: flips per served request
        out["bit_error_rate"] = float(out["flips"]) / max(int(out["served"]),
                                                          1)
    return out


def _group_tables(sys: SystemConfig, idxs, lb, pol, bb: int, device):
    """One group's decision inputs: the packed policy tables ``[bb, lb + 1,
    4]`` (None for the legacy scheduler flag), the cost pairs ``[bb, 2]``,
    the table bucket (0 without tables) and whether a table loads
    ``para_rand`` (the fault path). Runtime tables come one per row; a
    staged ``sys.policy`` is the same table on every row, at ``sys``'s
    decision cost."""
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
    if progs is None:
        return None, costs, 0, False
    para = any(p.uses(smcprog.OP_PARA_RAND) for p in progs)
    packed = [smcprog.pack_program(p, lb) for p in progs]
    packed += [packed[0]] * (bb - len(packed))
    return torch.from_numpy(np.stack(packed)).to(device), costs, lb, para


def _group_blooms(blooms, idxs, bb: int, device):
    """One group's Bloom words ``[1 or bb, W]`` and (k, m_bits), or None."""
    if blooms is None:
        return None
    if isinstance(blooms, tuple):
        words = words_tensor(blooms[0], device).unsqueeze(0)
        return words.contiguous(), int(blooms[1]), int(blooms[2])
    rows_w = [np.asarray(blooms[i][0]) for i in idxs]
    rows_w += [rows_w[0]] * (bb - len(idxs))
    words = words_tensor(np.stack(rows_w), device)
    return words.contiguous(), int(blooms[0][1]), int(blooms[0][2])


def _probe(bf, bank: torch.Tensor, row: torch.Tensor,
           n_rows: int) -> torch.Tensor:
    """The weak-row flags ``[B, N]`` int8 of requests to (bank, row)."""
    words, k, m_bits = bf
    keys = wrap32(bank.long() * n_rows + row.long())
    return ops.bloom_probe(words, keys, k, m_bits)


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

    bf = _group_blooms(blooms, idxs, bb, device)
    weak = None if bf is None else _probe(bf, bank, row, geo.n_rows)

    tables, costs, lb, para = _group_tables(sys, idxs, lb, pol, bb, device)
    slots = slot_budget(bucket, max(traces[i].n_real for i in idxs))
    p = _scan_params(sys, gmode, bb, bucket, slots, lb, weak is not None,
                     para)
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
    With a fault model (``sys.faults``) each result gains the fault
    fields and ``bit_error_rate``. Returns one result dict per trace, in
    input order."""
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


# ---------------------------------------------------------------------------
# Streaming: unbounded traces in constant-memory windows, bit-identical to
# single-shot (the reference's run_stream section).
#
# A stream is consumed in windows of L = halo + chunk requests. Each window
# (a) shifts the carried arrays left by ``chunk`` (the retired entries are
# final), appends the fresh chunk (t_issue 0, t_resp BIG, and with a Bloom
# filter its weak flags from one bloom_probe launch), rebases the queue and
# the pointer by -chunk, and (b) runs the slot scan's window entry
# (ops.slot_scan_window) for the window's slot budget under the freeze
# rule: a slot runs only while ptr <= L - FRONTIER_UPTO, else it is the
# identity. The streamed slot sequence is therefore the single-shot one
# with identity steps inserted. After an interior window every entry below
# ``chunk`` is issued and served, and the window emits [0, chunk); the
# window that exhausts the group lifts the freeze (final=1), drains the
# tail within the same budget and emits its whole [0, L). The virtual
# window-0 halo is all NOP with t_issue 0 and t_resp -1, so the frontier's
# lookback terms read 0, the single-shot out-of-range defaults. Times stay
# absolute int32: a stream saturates at ~2^30 modeled cycles, checked at
# the accumulator.
# ---------------------------------------------------------------------------

DEFAULT_STREAM_CHUNK = 4096   # requests per window
DEFAULT_STREAM_DEP = 8        # max dep lookback admitted into a stream


def stream_halo(sys: SystemConfig, dep_max: int = DEFAULT_STREAM_DEP) -> int:
    """Carried-context length: the frontier looks back at most
    ``max(window, dep)`` entries, and up to ``FRONTIER_UPTO - 1``
    unissued entries may trail the pointer at a window handoff."""
    return FRONTIER_UPTO + max(int(sys.window), int(dep_max))


def stream_slot_budget(chunk: int, sys: SystemConfig) -> int:
    """Per-window slot budget: the fresh chunk (2 slots a request), the
    carried queued entries (2 * max(window, 2)) and slack (12). It also
    drains the freeze-lifted final window; surplus slots are no-ops."""
    return 2 * chunk + 2 * max(int(sys.window), 2) + 12


def _nop_fields(k: int) -> tuple:
    z = np.zeros(k, np.int32)
    return (np.full(k, NOP, np.int32), z, z, z, z)


class _Chunker:
    """Re-buffer a stream of :class:`Trace` windows into exact
    ``chunk``-sized int32 field blocks, NOP-padding past the end. Accepts
    a single Trace, an iterable of Traces, or a zero-arg callable
    returning one (a generator factory). Holds O(chunk + largest yielded
    window) host memory."""

    __slots__ = ("it", "chunk", "dep_max", "parts", "buffered",
                 "exhausted", "n")

    def __init__(self, stream, chunk: int, dep_max: int):
        if isinstance(stream, Trace):
            stream = (stream,)
        elif callable(stream):
            stream = stream()
        self.it = iter(stream)
        self.chunk = chunk
        self.dep_max = dep_max
        self.parts: list = []    # pending (kind, bank, row, delta, dep)
        self.buffered = 0
        self.exhausted = False
        self.n = 0               # total requests pulled (incl. user NOPs)

    @property
    def done(self) -> bool:
        return self.exhausted and self.buffered == 0

    def _pull(self) -> None:
        try:
            tr = next(self.it)
        except StopIteration:
            self.exhausted = True
            return
        if not isinstance(tr, Trace):
            raise TypeError(
                f"streams must yield Trace windows, got {type(tr).__name__}")
        dep = np.asarray(tr.dep, np.int32)
        if dep.size and (int(dep.max()) > self.dep_max or int(dep.min()) < 0):
            raise ValueError(
                f"stream window has dep={int(dep.max())} outside "
                f"[0, dep_max={self.dep_max}]; raise dep_max (grows the "
                f"carried halo) or re-author the trace")
        self.parts.append(tuple(
            np.asarray(getattr(tr, f), np.int32) for f in TRACE_FIELDS))
        self.buffered += tr.n
        self.n += tr.n

    def next_block(self) -> tuple:
        """The next ``chunk`` requests as (kind, bank, row, delta, dep)
        arrays; all-NOP once the stream is exhausted."""
        while self.buffered < self.chunk and not self.exhausted:
            self._pull()
        fields: list = [[] for _ in range(5)]
        need = self.chunk
        while need and self.parts:
            part = self.parts[0]
            take = min(need, part[0].shape[0])
            for f, arr in zip(fields, part):
                f.append(arr[:take])
            if take == part[0].shape[0]:
                self.parts.pop(0)
            else:
                self.parts[0] = tuple(arr[take:] for arr in part)
            self.buffered -= take
            need -= take
        if need:
            for f, p in zip(fields, _nop_fields(need)):
                f.append(p)
        return tuple(np.concatenate(f) if len(f) != 1 else f[0]
                     for f in fields)


class _StreamAccum:
    """Per-stream output accumulator over emitted window blocks.

    ``collect='aggregate'`` keeps O(1) state: int64-exact latency sums and
    running maxima (the mean equals the full-mode one). ``collect='full'``
    also keeps every emitted block and reassembles exact per-request
    ``t_issue`` / ``t_resp`` arrays of the stream's length."""

    __slots__ = ("collect", "halo", "blocks", "n_requests", "lat_sum",
                 "last_resp", "last_issue")

    def __init__(self, collect: str, halo: int):
        self.collect = collect
        self.halo = halo
        self.blocks: list = []
        self.n_requests = 0
        self.lat_sum = 0
        self.last_resp = 0
        self.last_issue = 0

    def feed(self, kind_blk, issue_blk, resp_blk) -> None:
        valid = kind_blk != NOP  # virtual-halo and padding entries are NOP
        if valid.any():
            resp = resp_blk[valid].astype(np.int64)
            issue = issue_blk[valid].astype(np.int64)
            if (resp >= int(BIG)).any() or (resp < 0).any():
                raise RuntimeError(
                    "streaming invariant violated: a retired window slice "
                    "holds an unserved or time-wrapped request (t_resp "
                    "outside [0, 2^30)) — slot budget or int32 time "
                    "horizon exceeded")
            self.n_requests += int(valid.sum())
            self.lat_sum += int((resp - issue).sum())
            self.last_resp = max(self.last_resp, int(resp.max()))
            self.last_issue = max(self.last_issue, int(issue.max()))
        if self.collect == "full":
            self.blocks.append((kind_blk, issue_blk, resp_blk))

    def result(self, n: int, hits: int, served: int, dram_ticks: int,
               smc: int, sys: SystemConfig, mode: str) -> dict:
        if served != self.n_requests:
            raise RuntimeError(
                f"streaming invariant violated: {served} serve slots vs "
                f"{self.n_requests} retired non-NOP requests")
        exec_cycles = max(self.last_resp, self.last_issue)
        out = {
            "exec_cycles": np.int32(exec_cycles),
            "row_hits": np.int32(hits),
            "served": np.int32(served),
            "dram_ticks": np.int32(dram_ticks),
            "smc_fpga_cycles": np.int32(smc),
            "exec_seconds": sys.cycles_to_seconds(exec_cycles, mode),
            "mode": mode,
            "n_requests": self.n_requests,
        }
        if self.collect == "full":
            H = self.halo
            kind = np.concatenate([b[0] for b in self.blocks])[H:H + n]
            t_issue = np.concatenate([b[1] for b in self.blocks])[H:H + n]
            t_resp = np.concatenate([b[2] for b in self.blocks])[H:H + n]
            lat = t_resp - t_issue
            ok = (kind != NOP) & (t_resp < int(BIG))
            out["avg_load_latency_cycles"] = \
                float(lat[ok].mean()) if ok.any() else 0.0
            out["t_resp"] = t_resp
            out["t_issue"] = t_issue
        else:
            out["avg_load_latency_cycles"] = \
                self.lat_sum / self.n_requests if self.n_requests else 0.0
        return out


def shift_window(ss: StreamState, fresh: dict, chunk: int) -> StreamState:
    """The window handoff: drop the ``chunk`` oldest entries of every
    carried array, append the fresh chunk's trace arrays (``fresh``:
    field -> ``[B, chunk]`` int32 tensor; the weak flags are appended by
    the caller) with t_issue 0 and t_resp BIG, and rebase the queue and
    the pointer by -chunk (live queue entries sit in the halo, at
    index >= chunk). Torch ops on the carry's device."""
    C = chunk
    e = ss.emu
    B = e.t_issue.shape[0]

    def shift(a, tail):
        return torch.cat([a[:, C:], tail], 1)

    i32 = dict(dtype=torch.int32, device=e.t_issue.device)
    emu = dataclasses.replace(
        e, t_issue=shift(e.t_issue, torch.zeros((B, C), **i32)),
        t_resp=shift(e.t_resp, torch.full((B, C), BIG, **i32)),
        queue=torch.where(e.queue >= 0, e.queue - C, e.queue),
        ptr=e.ptr - C)
    return StreamState(emu=emu, weak=ss.weak, **{
        f: shift(getattr(ss, f), fresh[f]) for f in TRACE_FIELDS})


def _check_stream_args(sys: SystemConfig, chunk, dep_max: int,
                       collect: str) -> None:
    """The reference's checks of a stream's chunk and collect mode."""
    H = stream_halo(sys, dep_max)
    if not isinstance(chunk, (int, np.integer)) or isinstance(chunk, bool) \
            or chunk < H:
        raise ValueError(
            f"stream chunk must be an int >= halo ({H} = {FRONTIER_UPTO} "
            f"+ max(window={sys.window}, dep_max={dep_max})) so the final "
            f"window drains the whole tail in-budget, got {chunk!r}")
    if collect not in ("full", "aggregate"):
        raise ValueError(
            f"collect must be 'full' or 'aggregate', got {collect!r}")


class _Clock:
    """Host seconds of a stream's window parts, summed by part, when
    ``timings`` is a dict (else a no-op). Each part ends with a device
    sync, so that the device work it queued counts in it."""

    def __init__(self, timings: Optional[dict], device):
        self.t = timings
        self.sync = (timings is not None and device.type == "cuda")
        self.t0 = time.perf_counter()

    def lap(self, part: str) -> None:
        if self.t is None:
            return
        if self.sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.t[part] = self.t.get(part, 0.0) + (now - self.t0)
        self.t0 = now


def _run_stream_group(streams, idxs, gmode, lb, sys, modes, blooms, pol,
                      chunk: int, dep_max: int, collect: str, device,
                      results, timings) -> None:
    """Run one (mode, table-bucket) group's streams in lockstep windows
    on the caller's thread."""
    geo = sys.geometry
    H = stream_halo(sys, dep_max)
    L = chunk + H
    B = len(idxs)
    bf = _group_blooms(blooms, idxs, B, device)
    tables, costs, lb, para = _group_tables(sys, idxs, lb, pol, B, device)
    p = _scan_params(sys, gmode, B, L, stream_slot_budget(chunk, sys), lb,
                     bf is not None, para)
    chunkers = [_Chunker(streams[i], chunk, dep_max) for i in idxs]
    accs = [_StreamAccum(collect, H) for _ in idxs]
    ss = StreamState.init(chunk, H, sys, B, bf is not None, device)
    clock = _Clock(timings, device)
    first = True
    while True:
        blocks = [c.next_block() for c in chunkers]
        final = all(c.done for c in chunkers)
        stacked = [np.stack([b[f] for b in blocks]) for f in range(5)]
        clock.lap("generate")
        if stacked[1].min() < 0 or stacked[1].max() >= geo.n_banks:
            raise ValueError(f"trace banks must lie in [0, {geo.n_banks})")
        fresh = {f: torch.from_numpy(a).to(device)
                 for f, a in zip(TRACE_FIELDS, stacked)}
        ss = shift_window(ss, fresh, chunk)
        clock.lap("stage")
        if bf is not None:
            # the first window probes its virtual halo too (key 0, which
            # the reference probes if a free lane wins); later ones only
            # their fresh chunk, and the halo's flags shift with it
            if first:
                ss.weak = _probe(bf, ss.bank, ss.row, geo.n_rows)
            else:
                ss.weak = torch.cat([ss.weak[:, chunk:], _probe(
                    bf, fresh["bank"], fresh["row"], geo.n_rows)], 1)
            clock.lap("probe")
        ss.emu = ops.slot_scan_window(ss.emu, ss.kind, ss.bank, ss.row,
                                      ss.delta, ss.dep, ss.weak, tables,
                                      costs, p, final)
        clock.lap("scan")
        # interior windows retire exactly [0, chunk); the final one keeps
        # its whole [0, L) carry (the tail: that is the flush)
        keep = L if final else chunk
        out = torch.stack([ss.kind[:, :keep], ss.emu.t_issue[:, :keep],
                           ss.emu.t_resp[:, :keep]]).cpu().numpy()
        ptr = ss.emu.ptr.cpu().numpy()
        for j, acc in enumerate(accs):
            acc.feed(*out[:, j])
        clock.lap("copy")
        if final:
            break
        if (ptr <= L - FRONTIER_UPTO).any():
            raise RuntimeError(
                f"streaming invariant violated: issue frontier fell "
                f"behind the window (ptr={ptr.tolist()}, window={L}, "
                f"slots={p.slots}) — slot budget too small")
        first = False

    e = ss.emu
    hits, served, dram_now, smc = (
        v.cpu().numpy() for v in (e.hits, e.served_n, e.dram_now,
                                  e.smc_fpga_cycles))
    # the fault carry rides the state through every window untouched by
    # the shift: the final window's state is the whole stream's record
    fhost = ({k: v.cpu().numpy() for k, v in e.faults.items()}
             if sys.faults is not None else None)
    for j, i in enumerate(idxs):
        results[i] = accs[j].result(
            chunkers[j].n, int(hits[j]), int(served[j]), int(dram_now[j]),
            int(smc[j]), sys, modes[i])
        if fhost is not None:
            frow = {kk: v[j] for kk, v in fhost.items()}
            results[i].update(fault_result_fields(frow))
            results[i]["bit_error_rate"] = \
                int(frow["vptr"]) / max(int(served[j]), 1)


def run_stream_many(streams: Sequence, sys: SystemConfig,
                    mode: Union[str, Sequence[str]] = "ts", blooms=None,
                    chunk: int = DEFAULT_STREAM_CHUNK,
                    dep_max: int = DEFAULT_STREAM_DEP,
                    collect: str = "full", policies=None, policy_costs=None,
                    device=None, timings: Optional[dict] = None
                    ) -> List[dict]:
    """Evaluate many unbounded traces under one ``SystemConfig`` in
    lockstep constant-memory windows.

    Each stream is a :class:`Trace`, an iterable of Trace windows, or a
    zero-arg callable returning one (a generator factory); its length
    need not be known. Streams group by (normalized mode, policy-table
    bucket); each group runs its windows serially, one launch of the slot
    scan's window entry per window (plus one ``bloom_probe`` launch with a
    filter), and exhausted streams idle on NOP windows until the group
    drains. Device memory is O(batch * (chunk + halo)); host memory is
    O(chunk) per stream with ``collect='aggregate'`` or O(length) with
    ``collect='full'`` (which adds exact per-request ``t_resp`` /
    ``t_issue``). Results equal single-shot :func:`run_many` on every
    field for every chunk >= the halo. ``dep_max`` bounds the admissible
    ``dep`` lookbacks (it sizes the halo). With a fault model each result
    gains the fault fields and ``bit_error_rate``. ``timings``, a dict,
    collects the host seconds of the windows' parts (generate, stage,
    probe, scan, copy), each closed by a device sync."""
    dev = resolve_device(device)
    streams = list(streams)
    n = len(streams)
    modes = _check_modes([mode] * n if isinstance(mode, str) else mode, n)
    blooms = _normalize_blooms(blooms, n)
    pol = _normalize_policies(policies, policy_costs, sys, n)
    _check_stream_args(sys, chunk, dep_max, collect)
    groups: dict = {}
    for i in range(n):
        lb = None if pol is None else smcprog.table_bucket(pol[0][i].n_ops)
        groups.setdefault((_norm_mode(modes[i]), lb), []).append(i)
    results: List[Optional[dict]] = [None] * n
    for (gmode, lb), idxs in groups.items():
        _run_stream_group(streams, idxs, gmode, lb, sys, modes, blooms, pol,
                          int(chunk), dep_max, collect, dev, results,
                          timings)
    return results


def run_stream(stream, sys: SystemConfig, mode: str = "ts",
               bloom: Optional[tuple] = None,
               chunk: int = DEFAULT_STREAM_CHUNK,
               dep_max: int = DEFAULT_STREAM_DEP,
               collect: str = "full", device=None) -> dict:
    """Single-stream wrapper over :func:`run_stream_many` (see there)."""
    return run_stream_many([stream], sys, mode=mode, blooms=bloom,
                           chunk=chunk, dep_max=dep_max, collect=collect,
                           device=device)[0]
