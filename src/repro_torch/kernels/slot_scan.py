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
float); its field order is the kernel's ``ScanParams`` struct. The plain
version is ``repro_torch.kernels.ref.slot_scan_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

FAST_Q = 64        # SCAN_MAX_Q in slot_scan.cu
FAST_BANKS = 64    # SCAN_MAX_BANKS
FAST_TABLE = 256   # REPRO_VM_MAX_L in policy_vm.cuh
RESP_RING = 1024   # SCAN_RESP_RING: the fast instantiation's t_resp ring

STAT_FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
               "smc_fpga_cycles")


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


def slot_scan_cuda(kind, bank, row, delta, dep, weak: Optional[torch.Tensor],
                   tables: Optional[torch.Tensor], costs: torch.Tensor,
                   p: ScanParams) -> dict:
    """Launch the kernel on the current stream. Trace arrays ``[B, N]``
    int32, ``weak`` ``[B, N]`` int8 or None, ``tables`` ``[B, L + 1, 4]``
    int32 or None, ``costs`` ``[B, 2]`` int32 (counter_inc, smc_latency).
    Returns the seven output fields as CUDA tensors."""
    from repro_torch.kernels import ops
    dev = kind.device
    if dev.type != "cuda":
        raise ValueError(f"slot_scan_cuda needs CUDA tensors, got {dev}")
    if p.q < 2 or p.window > p.q or p.n_banks < 1 or p.table_len < 0 \
            or p.tREFI < 1:
        raise ValueError(
            f"slot_scan: invalid configuration, which the reference engine "
            f"cannot run either: queue >= 2 (got {p.q}), window <= queue "
            f"(got {p.window}), banks >= 1 (got {p.n_banks}), table >= 0 "
            f"(got {p.table_len}), tREFI >= 1 (got {p.tREFI})")
    shape = (p.batch, p.n)
    for nm, t in (("kind", kind), ("bank", bank), ("row", row),
                  ("delta", delta), ("dep", dep)):
        _check(nm, t, shape, torch.int32, dev)
    if (weak is not None) != bool(p.use_weak):
        raise ValueError("slot_scan: weak flags and use_weak disagree")
    if weak is not None:
        _check("weak", weak, shape, torch.int8, dev)
    if (tables is not None) != (p.table_len > 0):
        raise ValueError("slot_scan: tables and table_len disagree")
    if tables is not None:
        _check("tables", tables, (p.batch, p.table_len + 1, 4), torch.int32,
               dev)
    _check("costs", costs, (p.batch, 2), torch.int32, dev)

    t_issue = torch.zeros(shape, dtype=torch.int32, device=dev)
    t_resp = torch.full(shape, 2 ** 30, dtype=torch.int32, device=dev)
    stats = torch.zeros((p.batch, len(STAT_FIELDS)), dtype=torch.int32,
                        device=dev)
    if p.batch > 0:   # an empty batch launches nothing and counts nothing
        params = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
        ptr = ops.ptr
        lib = ops.library()
        tables = ops.aligned16(tables)   # the kernel loads rows as int4
        args = [params, ptr(kind), ptr(bank), ptr(row), ptr(delta), ptr(dep),
                ptr(weak), ptr(tables), ptr(costs), ptr(t_issue),
                ptr(t_resp), ptr(stats)]
        if instantiation(p) == "fast":
            err = lib.slot_scan_launch(*args, ops.stream_handle(dev))
            ops.check_launch("slot_scan", err, "fast")
        else:
            n_scratch = lib.slot_scan_wide_scratch_ints(params)
            if n_scratch < 0:
                raise ValueError(f"slot_scan: a row's state for {p} cannot "
                                 f"be indexed with 32-bit offsets")
            scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev) \
                if n_scratch else None
            err = lib.slot_scan_wide_launch(*args, ptr(scratch),
                                            ops.stream_handle(dev))
            ops.check_launch("slot_scan", err,
                             "wide-global" if n_scratch else "wide-shared")
    out = {f: stats[:, i] for i, f in enumerate(STAT_FIELDS)}
    out["t_resp"] = t_resp
    out["t_issue"] = t_issue
    return out
