"""Workload trace generators for the EasyDRAM engine.

Two families, mirroring the paper's evaluation:
* microbenchmarks — Copy/Init (Sec. 7), lmbench-style pointer-chase
  latency sweep (Fig. 8);
* PolyBench-like kernels (Sec. 6/8) — synthetic address streams with the
  suite's spread of memory intensities, filtered through the LLC model.

Host-side numpy throughout: for the same arguments (and, for PolyBench,
within one process — its seed folds in ``hash(kernel name)``, which
Python randomizes per process) the arrays are byte-identical to the
reference generators.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cachesim import LLC, filter_stream
from repro_torch.core.dram import Geometry, RC_COPY, RC_INIT, READ, WRITE
from repro_torch.core.emulator import Trace


def addr_to_bank_row(addrs, geo: Geometry):
    """Physical->DRAM mapping: row-interleaved across banks (XOR mix)."""
    addrs = np.asarray(addrs, np.int64)
    rbuf = addrs // geo.row_bytes
    bank = (rbuf ^ (rbuf >> 4)) % geo.n_banks
    row = (rbuf // geo.n_banks) % geo.n_rows
    return bank.astype(np.int32), row.astype(np.int32)


def dram_trace_from_stream(addrs, writes, geo: Geometry, delta=8, window_dep=0):
    bank, row = addr_to_bank_row(addrs, geo)
    n = len(addrs)
    kind = np.where(np.asarray(writes), WRITE, READ).astype(np.int32)
    return Trace.of(kind=kind, bank=bank, row=row,
                    delta=np.full(n, delta, np.int32),
                    dep=np.full(n, window_dep, np.int32))


# ---------------- microbenchmarks ----------------

def pointer_chase(n_bytes: int, geo: Geometry, stride=64, n_loads=4096,
                  compute_delta=4, llc: LLC = None, seed=0):
    """lmbench-style memory read latency benchmark over an n_bytes region.

    Dependent loads (dep=1): each load's address depends on the previous
    response — the latency-revealing access pattern of Fig. 8."""
    rng = np.random.RandomState(seed)
    n_lines = max(n_bytes // stride, 1)
    perm = rng.permutation(n_lines)
    addrs = (perm[np.arange(n_loads) % n_lines] * stride).astype(np.int64)
    da, dw, _ = filter_stream(addrs, np.zeros(len(addrs), bool), llc or LLC())
    if len(da) == 0:  # fully cache-resident
        return None
    tr = dram_trace_from_stream(da, dw, geo, delta=compute_delta)
    tr.dep[:] = 1  # chase: every DRAM access depends on the previous one
    return tr, len(addrs), len(da)


def copy_workload(n_bytes: int, geo: Geometry, mode: str, device=None,
                  setting: str = "noflush", alloc_base_row: int = 64,
                  cpu_line_delta: int = 6):
    """Copy an n_bytes source array into a destination array.

    mode: 'cpu' (load/store per line) or 'rowclone' (FPM copy per row,
    with CPU fallback on unclonable pairs). setting: 'noflush' |
    'clflush' (dirty source lines must be written back first).
    Returns (Trace, meta)."""
    lines = max(n_bytes // geo.line_bytes, 1)
    rows = max(n_bytes // geo.row_bytes, 1)
    kinds, banks, rws, deltas, deps = [], [], [], [], []
    meta = {"fallback_rows": 0, "rows": rows}

    def emit(kind, bank, row, delta, dep=0):
        kinds.append(kind)
        banks.append(bank)
        rws.append(row)
        deltas.append(delta)
        deps.append(dep)

    if setting == "clflush":
        # write back dirty cached copies of the source (worst case: all)
        for i in range(lines):
            ri = (i * geo.line_bytes) // geo.row_bytes
            bank = ri % geo.n_banks
            srow = (alloc_base_row + 2 * (ri // geo.n_banks)) % geo.n_rows
            emit(WRITE, bank, srow, 2)

    # RowClone-aware allocation (Sec. 7.1): rows pair within the SAME bank
    # and 512-row subarray; the allocator *profiles* candidate (src, dst)
    # pairs (the paper's 1000-op test) and only assigns clonable ones, so
    # CPU fallback happens just when no candidate in the subarray works.
    def pair(i):
        bank = i % geo.n_banks
        srow = (alloc_base_row + 2 * (i // geo.n_banks)) % geo.n_rows
        if device is None:
            return bank, srow, srow + 1
        sa = geo.subarray_rows
        sa_base = (srow // sa) * sa
        for off in range(1, 9):  # profile up to 8 candidate destinations
            drow = sa_base + (srow - sa_base + off) % sa
            if device.clonable(bank, int(srow), int(drow)):
                return bank, srow, drow
        return bank, srow, srow + 1  # profiling failed -> fallback pair

    if mode == "cpu":
        # CPU baseline uses a NORMAL allocation: src/dst regions interleave
        # across banks at row granularity (streaming row hits, no forced
        # same-bank ping-pong)
        for i in range(lines):
            ri = (i * geo.line_bytes) // geo.row_bytes
            # dst region offset co-prime with the bank count so src/dst
            # streams occupy different banks (as a real interleaver does)
            sr = alloc_base_row + ri
            dr = alloc_base_row + 2 * rows + geo.n_banks // 2 + 1 + ri
            emit(READ, sr % geo.n_banks, sr // geo.n_banks % geo.n_rows,
                 cpu_line_delta)
            emit(WRITE, dr % geo.n_banks, dr // geo.n_banks % geo.n_rows,
                 cpu_line_delta)
    else:
        for i in range(rows):
            bank, srow, drow = pair(i)
            ok = device is None or device.clonable(bank, int(srow), int(drow))
            if ok:
                # synchronous driver call: each RC op waits for completion
                emit(RC_COPY, bank, drow, 12, dep=1)
            else:  # CPU fallback for this row
                meta["fallback_rows"] += 1
                for j in range(geo.lines_per_row):
                    emit(READ, bank, srow, cpu_line_delta)
                    emit(WRITE, bank, drow, cpu_line_delta)
    return Trace.of(kinds, banks, rws, deltas, deps), meta


def init_workload(n_bytes: int, geo: Geometry, mode: str, device=None,
                  setting: str = "noflush", alloc_base_row: int = 8192,
                  cpu_line_delta: int = 4):
    """Initialize an n_bytes array with a pattern (one source row per
    subarray, cloned into every destination row)."""
    lines = max(n_bytes // geo.line_bytes, 1)
    rows = max(n_bytes // geo.row_bytes, 1)
    kinds, banks, rws, deltas, deps = [], [], [], [], []
    meta = {"fallback_rows": 0, "rows": rows}

    def emit(kind, bank, row, delta, dep=0):
        kinds.append(kind)
        banks.append(bank)
        rws.append(row)
        deltas.append(delta)
        deps.append(dep)

    if setting == "clflush":
        for i in range(rows):  # invalidate destination rows' cached lines
            r = alloc_base_row + i
            emit(WRITE, r % geo.n_banks, r // geo.n_banks % geo.n_rows, 1)

    if mode == "cpu":
        for i in range(lines):
            drow = alloc_base_row + (i * geo.line_bytes) // geo.row_bytes
            emit(WRITE, drow % geo.n_banks, drow // geo.n_banks % geo.n_rows,
                 cpu_line_delta)
    else:
        for i in range(rows):
            dr = alloc_base_row + i
            bank = dr % geo.n_banks
            drow = dr // geo.n_banks % geo.n_rows
            sa = geo.subarray_rows
            sa_base = (drow // sa) * sa  # one source row per subarray
            ok = False
            for off in (0, 1, 2, 3):     # profile a few source candidates
                if device is None or device.clonable(bank, int(sa_base + off), int(drow)):
                    ok = True
                    break
            if ok:
                emit(RC_INIT, bank, drow, 12, dep=1)
            else:
                meta["fallback_rows"] += 1
                for j in range(geo.lines_per_row):
                    emit(WRITE, bank, drow, cpu_line_delta)
    return Trace.of(kinds, banks, rws, deltas, deps), meta


# ---------------- PolyBench-like kernels ----------------

@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    arrays: tuple          # (n_bytes, stride, passes) per array
    compute_per_access: int
    dep: int = 0           # 1 = loop-carried dependence (latency-bound)


# spread of memory intensity mirroring the suite (durbin ~0.01 LLC MPKC,
# gemm blocked reuse, streaming stencils, etc.)
POLYBENCH = (
    Kernel("gemm",       ((1 << 21, 64, 2), (1 << 21, 64, 2), (1 << 20, 64, 1)), 48),
    Kernel("2mm",        ((1 << 21, 64, 2), (1 << 21, 64, 2), (1 << 21, 64, 2)), 40),
    Kernel("3mm",        ((1 << 21, 64, 3), (1 << 21, 64, 2), (1 << 21, 64, 2)), 40),
    Kernel("atax",       ((1 << 22, 64, 2), (1 << 16, 64, 4)), 10),
    Kernel("bicg",       ((1 << 22, 64, 2), (1 << 16, 64, 4)), 10),
    Kernel("mvt",        ((1 << 22, 64, 2), (1 << 16, 64, 2)), 10),
    Kernel("gemver",     ((1 << 22, 64, 3), (1 << 16, 64, 2)), 14),
    Kernel("gesummv",    ((1 << 22, 64, 2), (1 << 16, 64, 2)), 8),
    Kernel("syrk",       ((1 << 21, 64, 2), (1 << 20, 64, 2)), 36),
    Kernel("syr2k",      ((1 << 21, 64, 3), (1 << 20, 64, 2)), 32),
    Kernel("trmm",       ((1 << 21, 64, 2),), 30),
    Kernel("symm",       ((1 << 21, 64, 2), (1 << 20, 64, 2)), 34),
    Kernel("cholesky",   ((1 << 21, 64, 2),), 26, dep=1),
    Kernel("lu",         ((1 << 21, 64, 3),), 24, dep=1),
    Kernel("ludcmp",     ((1 << 21, 64, 3), (1 << 16, 64, 2)), 24, dep=1),
    Kernel("trisolv",    ((1 << 20, 64, 2), (1 << 16, 64, 2)), 8, dep=1),
    Kernel("durbin",     ((1 << 15, 64, 8),), 12, dep=1),
    Kernel("gramschmidt", ((1 << 21, 64, 3),), 28, dep=1),
    Kernel("correlation", ((1 << 21, 64, 3),), 22),
    Kernel("covariance", ((1 << 21, 64, 3),), 22),
    Kernel("jacobi-1d",  ((1 << 21, 64, 4),), 6),
    Kernel("jacobi-2d",  ((1 << 21, 64, 4),), 8),
    Kernel("seidel-2d",  ((1 << 21, 64, 4),), 10, dep=1),
    Kernel("heat-3d",    ((1 << 21, 64, 4),), 10),
    Kernel("fdtd-2d",    ((1 << 21, 64, 4),), 9),
    Kernel("adi",        ((1 << 21, 64, 4),), 14, dep=1),
    Kernel("doitgen",    ((1 << 21, 64, 2), (1 << 16, 64, 4)), 20),
    Kernel("deriche",    ((1 << 21, 64, 4),), 12),
)


def polybench_stream(kern: Kernel, max_accesses=60000, seed=0):
    """CPU-level address stream for a kernel: interleaved strided passes."""
    rng = np.random.RandomState(seed + hash(kern.name) % 1000)
    streams = []
    base = 0
    for (nb, stride, passes) in kern.arrays:
        lines = nb // stride
        for p in range(passes):
            a = base + (np.arange(lines) * stride)
            if kern.name in ("gemm", "2mm", "3mm", "syrk", "syr2k", "symm"):
                # blocked reuse: revisit tiles
                tile = max(lines // 16, 1)
                idx = np.concatenate([np.tile(np.arange(i, min(i + tile, lines)), 3)
                                      for i in range(0, lines, tile)])
                a = base + idx * stride
            streams.append(a)
        base += nb * 2
    n = min(max_accesses, sum(len(s) for s in streams))
    # round-robin interleave the array passes
    out = np.empty(n, np.int64)
    k = len(streams)
    ptrs = [0] * k
    for i in range(n):
        j = i % k
        s = streams[j]
        out[i] = s[ptrs[j] % len(s)]
        ptrs[j] += 1
    writes = rng.rand(n) < 0.3
    return out, writes


def polybench_trace(kern: Kernel, geo: Geometry, max_accesses=60000, seed=0):
    addrs, writes = polybench_stream(kern, max_accesses, seed)
    da, dw, llc = filter_stream(addrs, writes)
    if len(da) == 0:
        return None, 0
    tr = dram_trace_from_stream(da, dw, geo, delta=kern.compute_per_access,
                                window_dep=kern.dep)
    return tr, len(addrs)
