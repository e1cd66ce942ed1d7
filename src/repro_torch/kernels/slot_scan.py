"""The slot-scan kernel's host side: its parameter block and CUDA wrapper.

The kernel (``csrc/slot_scan.cu``) runs one trace row of a batch group
through the whole slot budget in one warp (one block of 32 threads per
row, queue lanes across the warp, the row's state on chip), in place of
the reference engine's ``lax.scan`` over its slot body. It has two
instantiations, picked here from the group's shape alone
(:func:`instantiation`): the fast one for a queue of up to
:data:`FAST_Q` lanes, up to :data:`FAST_BANKS` banks and a policy table
of up to :data:`FAST_TABLE` rows (every main-path group), and the wide
one for every other shape the reference takes, its row state in dynamic
shared memory or, where that does not fit, in global scratch allocated
here.
:class:`ScanParams` holds the group's host-computed scalars (computed in
Python ints and floats exactly as the reference does, never in device
float); its field order is the kernel's ``ScanParams`` struct followed
by its ``FaultParams``: the fault model's scalars and the threefry stream
keys, derived on the host (``core.threefry``) so that the device runs
only the per-slot part of each chain. A group with a fault model, or with
a policy table that loads ``para_rand``, runs the fault path
(``faults=1``: the fast instantiation's fault kernel); its outputs gain
the fault fields with a fault model. The plain
version is ``repro_torch.kernels.ref.slot_scan_ref``.

:func:`slot_scan_window_cuda` is the kernel's window entry, one stream
window of a group (``core.emulator.run_stream``): the window's
``EmulatorState`` in, the state after the window's slots out, under the
freeze gate and with no trailing pass; its plain version is
``repro_torch.kernels.ref.slot_scan_window_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core.faults import (DOMAIN_PARA, FAULT_LOGS, FAULT_SCALARS,
                                     domain_key)
from repro_torch.core.state import EmulatorState
from repro_torch.core.threefry import as_int32

FAST_Q = 64        # SCAN_MAX_Q in slot_scan.cu
FAST_BANKS = 64    # SCAN_MAX_BANKS
FAST_TABLE = 256   # REPRO_VM_MAX_L in policy_vm.cuh
RESP_RING = 1024   # SCAN_RESP_RING: the fast instantiation's t_resp ring

STAT_FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
               "smc_fpga_cycles")
# a stream window's scalars in the kernel's order (WindowIO.scal): the
# EmulatorState's, then the bank state's channel scalars
WINDOW_SCALARS = ("ptr", "mc_release", "dram_now", "hits", "served_n",
                  "smc_fpga_cycles", "last_bank")
WINDOW_BANK_SCALARS = ("bus_busy", "refs_done")
WINDOW_BANK_ARRAYS = ("open_row", "ready", "act_at")
# the fault carry's counters (fstats) and victim log (vlog), kernel order
WINDOW_FAULT_SCALARS = ("vptr", "ham_flips", "ret_flips", "mitigations")
WINDOW_FAULT_LOGS = ("vbank", "vrow", "vt")
# the PARA stream key of seed 0: para_rand's key without a fault model
PARA_KEY0 = tuple(as_int32(w) for w in domain_key(0, DOMAIN_PARA))


@dataclasses.dataclass(frozen=True)
class ScanParams:
    """One batch group's scalars (see ``emulator._scan_params``)."""
    batch: int
    n: int
    window: int
    q: int
    slots: int
    n_banks: int
    n_rows: int
    scale_num: int     # round(proc_per_tick * 4096), host double
    mc_lat: int        # per-response MC latency (0 in nots)
    mc_issue_ts: int   # hwmc_issue_proc: decision rate outside nots
    nots: int          # 1 = nots mode: the SMC cost pair sets issue/slack
    frfcfs: int        # legacy flag (used when table_len == 0)
    table_len: int     # policy table bucket, 0 = legacy flag
    use_weak: int      # 1 = Bloom-gated tRCD from per-request weak flags
    tRCD: int
    tRCD_reduced: int
    tCL: int
    tRP: int
    tRAS: int
    tWR: int
    tBL: int
    tRFC: int
    tREFI: int
    tRC_CLONE: int
    # the fault path, which the engine takes for a fault model or a table
    # that loads para_rand; off it (0) hammer_ct and para_rand load 0 in
    # both instantiations and in the plain engine
    faults: int = 0
    hammer_threshold: int = 0
    hammer_flip_fp: int = 0
    weak_fp: int = 0
    retention_ticks: int = 0
    victim_slots: int = 0   # the victim log's length; 0 = no fault model
    mit_ticks: int = 0      # a fired mitigation's extra ticks on the bank
    # threefry stream keys (hammer, weak, PARA) as int32 bit patterns
    kh0: int = 0
    kh1: int = 0
    kw0: int = 0
    kw1: int = 0
    kp0: int = PARA_KEY0[0]
    kp1: int = PARA_KEY0[1]

    def as_ints(self):
        return [int(getattr(self, f.name)) for f in dataclasses.fields(self)]


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"slot_scan: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def instantiation(p: ScanParams) -> str:
    """``"fast"`` or ``"wide"``: the kernel instantiation a group runs."""
    fast = p.q <= FAST_Q and p.n_banks <= FAST_BANKS \
        and p.table_len <= FAST_TABLE
    return "fast" if fast else "wide"


def variant(p: ScanParams, n_scratch: int = 0) -> str:
    """The launch's name in ``ops.variants()``: ``fast``, ``fast-faults``,
    ``wide-shared`` or ``wide-global``."""
    if instantiation(p) == "fast":
        return "fast-faults" if p.faults else "fast"
    return "wide-global" if n_scratch else "wide-shared"


def _check_inputs(name, kind, bank, row, delta, dep, weak, tables, costs,
                  p: ScanParams) -> None:
    """The checks both entries make of a group's configuration and
    inputs."""
    check_group(name, kind, bank, row, delta, dep, tables, costs, p)
    if (weak is not None) != bool(p.use_weak):
        raise ValueError("slot_scan: weak flags and use_weak disagree")
    if weak is not None:
        _check("weak", weak, (p.batch, p.n), torch.int8, kind.device)


def check_group(name, kind, bank, row, delta, dep, tables, costs,
                p: ScanParams) -> None:
    """The checks every scan kernel's wrapper makes of a group's
    configuration, trace arrays, policy tables and cost pairs."""
    dev = kind.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if p.q < 2 or p.window > p.q or p.n_banks < 1 or p.table_len < 0 \
            or p.tREFI < 1:
        raise ValueError(
            f"slot_scan: invalid configuration, which the reference engine "
            f"cannot run either: queue >= 2 (got {p.q}), window <= queue "
            f"(got {p.window}), banks >= 1 (got {p.n_banks}), table >= 0 "
            f"(got {p.table_len}), tREFI >= 1 (got {p.tREFI})")
    if p.victim_slots < 0 or (p.victim_slots > 0 and not p.faults):
        raise ValueError(f"slot_scan: a fault model (victim_slots "
                         f"{p.victim_slots}) runs with faults=1")
    shape = (p.batch, p.n)
    for nm, t in (("kind", kind), ("bank", bank), ("row", row),
                  ("delta", delta), ("dep", dep)):
        _check(nm, t, shape, torch.int32, dev)
    if (tables is not None) != (p.table_len > 0):
        raise ValueError("slot_scan: tables and table_len disagree")
    if tables is not None:
        _check("tables", tables, (p.batch, p.table_len + 1, 4), torch.int32,
               dev)
    _check("costs", costs, (p.batch, 2), torch.int32, dev)


def slot_scan_cuda(kind, bank, row, delta, dep, weak: Optional[torch.Tensor],
                   tables: Optional[torch.Tensor], costs: torch.Tensor,
                   p: ScanParams) -> dict:
    """Launch the kernel on the current stream. Trace arrays ``[B, N]``
    int32, ``weak`` ``[B, N]`` int8 or None, ``tables`` ``[B, L + 1, 4]``
    int32 or None, ``costs`` ``[B, 2]`` int32 (counter_inc, smc_latency).
    Returns the seven output fields as CUDA tensors, and the seven fault
    fields when ``p.victim_slots > 0``."""
    from repro_torch.kernels import ops
    _check_inputs("slot_scan_cuda", kind, bank, row, delta, dep, weak,
                  tables, costs, p)
    dev = kind.device
    shape = (p.batch, p.n)
    t_issue = torch.zeros(shape, dtype=torch.int32, device=dev)
    t_resp = torch.full(shape, 2 ** 30, dtype=torch.int32, device=dev)
    stats = torch.zeros((p.batch, len(STAT_FIELDS)), dtype=torch.int32,
                        device=dev)
    fstats = vlog = None
    if p.victim_slots > 0:
        fstats = torch.zeros((p.batch, len(FAULT_SCALARS)),
                             dtype=torch.int32, device=dev)
        vlog = torch.full((p.batch, len(FAULT_LOGS), p.victim_slots), -1,
                          dtype=torch.int32, device=dev)
    if p.batch > 0:   # an empty batch launches nothing and counts nothing
        params = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
        ptr = ops.ptr
        lib = ops.library()
        tables = ops.aligned16(tables)   # the kernel loads rows as int4
        args = [params, ptr(kind), ptr(bank), ptr(row), ptr(delta), ptr(dep),
                ptr(weak), ptr(tables), ptr(costs), ptr(t_issue),
                ptr(t_resp), ptr(stats), ptr(fstats), ptr(vlog)]
        if instantiation(p) == "fast":
            err = lib.slot_scan_launch(*args, ops.stream_handle(dev))
            ops.check_launch("slot_scan", err, variant(p))
        else:
            scratch = _wide_scratch(lib, params, p, dev)
            err = lib.slot_scan_wide_launch(*args, ptr(scratch),
                                            ops.stream_handle(dev))
            ops.check_launch("slot_scan", err,
                             variant(p, 0 if scratch is None else 1))
    out = {f: stats[:, i] for i, f in enumerate(STAT_FIELDS)}
    out["t_resp"] = t_resp
    out["t_issue"] = t_issue
    if fstats is not None:
        out.update({f: fstats[:, i] for i, f in enumerate(FAULT_SCALARS)})
        out.update({f: vlog[:, i] for i, f in enumerate(FAULT_LOGS)})
    return out


def _wide_scratch(lib, params, p: ScanParams, dev):
    """The wide instantiation's global scratch (None when a row's state
    fits in shared memory)."""
    n_scratch = lib.slot_scan_wide_scratch_ints(params)
    if n_scratch < 0:
        raise ValueError(f"slot_scan: a row's state for {p} cannot be "
                         f"indexed with 32-bit offsets")
    return (torch.empty(n_scratch, dtype=torch.int32, device=dev)
            if n_scratch else None)


def slot_scan_window_cuda(st: EmulatorState, kind, bank, row, delta, dep,
                          weak: Optional[torch.Tensor],
                          tables: Optional[torch.Tensor], costs: torch.Tensor,
                          p: ScanParams, final: bool) -> EmulatorState:
    """Launch the window entry on the current stream: one stream window
    of ``p.slots`` slots over the window's trace arrays ``[B, n]`` (the
    inputs of :func:`slot_scan_cuda`) from the shifted window state
    ``st``, the freeze lifted when ``final``. Returns the state after the
    window; ``st`` is left as it was."""
    from repro_torch.kernels import ops
    _check_inputs("slot_scan_window_cuda", kind, bank, row, delta, dep,
                  weak, tables, costs, p)
    dev = kind.device
    B, nb = p.batch, p.n_banks
    _check("t_issue", st.t_issue, (B, p.n), torch.int32, dev)
    _check("t_resp", st.t_resp, (B, p.n), torch.int32, dev)
    _check("queue", st.queue, (B, p.q), torch.int32, dev)
    carry = p.victim_slots > 0
    if carry != bool(st.faults):
        raise ValueError("slot_scan_window: the state's fault carry and "
                         "victim_slots disagree")
    t_issue, t_resp, queue = (st.t_issue.clone(), st.t_resp.clone(),
                              st.queue.clone())
    i32 = dict(dtype=torch.int32)
    scal = torch.stack([getattr(st, f) for f in WINDOW_SCALARS]
                       + [st.bank[f] for f in WINDOW_BANK_SCALARS],
                       1).to(**i32).contiguous()
    bst = torch.stack([st.bank[f] for f in WINDOW_BANK_ARRAYS],
                      1).to(**i32).contiguous()
    _check("bank state", bst, (B, 3, nb), torch.int32, dev)
    hct = fstats = vlog = None
    if carry:
        fs = st.faults
        hct = fs["hct"].to(**i32).contiguous().clone()
        fstats = torch.stack([fs[f] for f in WINDOW_FAULT_SCALARS],
                             1).to(**i32).contiguous()
        vlog = torch.stack([fs[f] for f in WINDOW_FAULT_LOGS],
                           1).to(**i32).contiguous()
        _check("hct", hct, (B, nb), torch.int32, dev)
        _check("victim log", vlog, (B, 3, p.victim_slots), torch.int32, dev)
    if B > 0:   # an empty batch launches nothing and counts nothing
        params = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
        lib = ops.library()
        bufs = [kind, bank, row, delta, dep, weak, ops.aligned16(tables),
                costs, t_issue, t_resp, queue, scal, bst, hct, fstats, vlog]
        arr = (ctypes.c_void_p * len(bufs))(*[ops.ptr(t) for t in bufs])
        wide = instantiation(p) == "wide"
        scratch = _wide_scratch(lib, params, p, dev) if wide else None
        err = lib.slot_scan_window_launch(params, int(bool(final)), arr,
                                          int(wide), ops.ptr(scratch),
                                          ops.stream_handle(dev))
        ops.check_launch("slot_scan_window", err,
                         variant(p, 0 if scratch is None else 1))
    scalars = dict(zip(WINDOW_SCALARS + WINDOW_BANK_SCALARS, scal.unbind(1)))
    faults = {}
    if carry:
        faults = {"hct": hct,
                  **dict(zip(WINDOW_FAULT_LOGS, vlog.unbind(1))),
                  **dict(zip(WINDOW_FAULT_SCALARS, fstats.unbind(1)))}
    return EmulatorState(
        bank={**dict(zip(WINDOW_BANK_ARRAYS, bst.unbind(1))),
              **{f: scalars[f] for f in WINDOW_BANK_SCALARS}},
        t_issue=t_issue, t_resp=t_resp, queue=queue,
        **{f: scalars[f] for f in WINDOW_SCALARS}, faults=faults)
