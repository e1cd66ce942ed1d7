"""The reference engine's scan kernel: its CUDA wrapper.

The kernel (``csrc/ref_scan.cu``) runs each trace row of a batch group
through the reference's pre-optimization slot body (the scan of
``repro.core.emulator._run_core_ref``) for ``p.slots`` slots, the uniform
``2 * n + 4`` of ``run_ref``, with one thread a row and the row's state in
global scratch allocated here. It takes the slot scan's inputs and
:class:`~repro_torch.kernels.slot_scan.ScanParams`, except that the Bloom
filter comes as its words (the kernel probes the picked request inside the
slot) instead of per-request weak flags. Its plain version is
``repro_torch.kernels.ref.ref_scan_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.faults import FAULT_LOGS, FAULT_SCALARS
from repro_torch.kernels.slot_scan import (STAT_FIELDS, ScanParams, _check,
                                           check_group)


def _check_bloom(bloom, p: ScanParams, dev) -> None:
    if (bloom is not None) != bool(p.use_weak):
        raise ValueError("ref_scan: a Bloom filter and use_weak disagree")
    if bloom is None:
        return
    words, k, m_bits = bloom
    if words.dim() != 2 or words.shape[0] not in (1, p.batch):
        raise ValueError(f"ref_scan: Bloom words must be [1 or {p.batch}, W], "
                         f"got {tuple(words.shape)}")
    _check("Bloom words", words, tuple(words.shape), torch.int32, dev)
    if not 1 <= k <= 8 or m_bits < 32 or m_bits & (m_bits - 1) \
            or words.shape[1] * 32 < m_bits:
        raise ValueError(f"ref_scan: a filter of k = {k} (1..8) hashes over "
                         f"m_bits = {m_bits} (a power of two >= 32, within "
                         f"{words.shape[1]} words)")


def ref_scan_cuda(kind, bank, row, delta, dep, bloom: Optional[tuple],
                  tables: Optional[torch.Tensor], costs: torch.Tensor,
                  p: ScanParams) -> dict:
    """Launch the kernel on the current stream. Trace arrays ``[B, N]``
    int32, ``bloom`` None or (words ``[1 or B, W]`` int32, k, m_bits),
    ``tables`` ``[B, L + 1, 4]`` int32 or None, ``costs`` ``[B, 2]`` int32
    (counter_inc, smc_latency). Returns the seven output fields as CUDA
    tensors, and the seven fault fields when ``p.victim_slots > 0``."""
    from repro_torch.kernels import ops
    check_group("ref_scan_cuda", kind, bank, row, delta, dep, tables, costs,
                p)
    dev = kind.device
    _check_bloom(bloom, p, dev)
    if p.slots < 0:
        raise ValueError(f"ref_scan: slots must be >= 0, got {p.slots}")
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
        lib = ops.library()
        ints = p.as_ints()
        params = (ctypes.c_int * len(ints))(*ints)
        scratch = torch.empty(
            p.batch * lib.ref_scan_row_ints(p.q, p.n_banks, p.table_len),
            dtype=torch.int32, device=dev)
        words, k, m_bits = (None, 0, 0) if bloom is None else bloom
        tables = ops.aligned16(tables)   # the kernel loads rows as int4
        ptr = ops.ptr
        err = lib.ref_scan_launch(
            params, ptr(kind), ptr(bank), ptr(row), ptr(delta), ptr(dep),
            ptr(words), 0 if words is None else words.shape[0],
            0 if words is None else words.shape[1], int(k), int(m_bits),
            ptr(tables), ptr(costs), ptr(t_issue),
            ptr(t_resp), ptr(stats), ptr(fstats), ptr(vlog), ptr(scratch),
            ops.stream_handle(dev))
        ops.check_launch("ref_scan", err)
    out = {f: stats[:, i] for i, f in enumerate(STAT_FIELDS)}
    out["t_resp"] = t_resp
    out["t_issue"] = t_issue
    if fstats is not None:
        out.update({f: fstats[:, i] for i, f in enumerate(FAULT_SCALARS)})
        out.update({f: vlog[:, i] for i, f in enumerate(FAULT_LOGS)})
    return out
