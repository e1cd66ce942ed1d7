"""Workload trace generators for the EasyDRAM engine.

Two families, mirroring the paper's evaluation:
* microbenchmarks — Copy/Init (Sec. 7), lmbench-style pointer-chase
  latency sweep (Fig. 8), and the RowHammer aggressor storm of the fault
  model;
* PolyBench-like kernels (Sec. 6/8) — synthetic address streams with the
  suite's spread of memory intensities, filtered through the LLC model.

And two traces of the LM serving side: one decode step's DRAM traffic
(:func:`lm_decode_trace`) and a KV-cache page fork as a bulk copy
(:func:`kv_fork_trace`).

Plus the streaming front door: :func:`load_trace_file` parses
ramulator-style / MemTraceProbe-style text traces (plain or ``.gz``)
into the address stream :func:`dram_trace_from_stream` consumes;
:func:`iter_trace_file_windows` and :func:`iter_windows` yield bounded
:class:`Trace` windows for ``emulator.run_stream``, so a long trace is
never materialized whole; :func:`synthetic_stream` generates a random
request stream window by window.

Host-side numpy throughout: for the same arguments (and, for PolyBench,
within one process — its seed folds in ``hash(kernel name)``, which
Python randomizes per process) the arrays are byte-identical to the
reference generators.
"""
from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator, Optional

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


def iter_windows(trace: Trace, window: int) -> Iterator[Trace]:
    """Slice a materialized trace into bounded windows (views, no copies):
    ``emulator.run_stream(iter_windows(tr, w), ...)`` equals
    ``run(tr, ...)`` for any window size."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for s in range(0, trace.n, window):
        e = min(s + window, trace.n)
        yield Trace(kind=trace.kind[s:e], bank=trace.bank[s:e],
                    row=trace.row[s:e], delta=trace.delta[s:e],
                    dep=trace.dep[s:e])


# ---------------- text trace files ----------------

_READ_TOKENS = frozenset(
    ["r", "rd", "read", "readreq", "readex", "ld", "load", "l", "p",
     "pim", "ifetch"])
_WRITE_TOKENS = frozenset(
    ["w", "wr", "write", "writereq", "writeback", "wb", "st", "store",
     "s"])


def _parse_int(tok: str, path: str, lineno: int) -> int:
    try:
        return int(tok, 0)   # decimal or 0x... hex
    except ValueError:
        raise ValueError(
            f"{path}:{lineno}: expected an address, got {tok!r}") from None


def _parse_op(tok: str) -> Optional[bool]:
    """R/W command token -> is_write, or None if not a command."""
    t = tok.lower()
    if t in _READ_TOKENS:
        return False
    if t in _WRITE_TOKENS:
        return True
    return None


def parse_trace_line(line: str, path: str = "<trace>",
                     lineno: int = 0) -> Optional[tuple]:
    """Parse one text-trace line into ``(addr, is_write)``; None for
    blanks and ``#``/``//`` comments. Accepted layouts (whitespace- or
    comma-separated, hex or decimal addresses):

    * ramulator style: ``<addr>`` | ``<addr> <R|W>`` | ``<R|W> <addr>``
    * MemTraceProbe/CSV style: ``<tick>, <cmd>, <addr>[, <size>]``
      (cmd spelled ReadReq / WriteReq / rd / wr / ...)

    Anything else raises a ValueError naming the file, line number and
    offending text."""
    s = line.split("#", 1)[0].split("//", 1)[0].strip()
    if not s:
        return None
    toks = s.replace(",", " ").split()
    if len(toks) == 1:
        return _parse_int(toks[0], path, lineno), False
    if len(toks) == 2:
        w = _parse_op(toks[1])
        if w is not None:
            return _parse_int(toks[0], path, lineno), w
        w = _parse_op(toks[0])
        if w is not None:
            return _parse_int(toks[1], path, lineno), w
    elif len(toks) in (3, 4):
        w = _parse_op(toks[1])
        if w is not None:  # tick, cmd, addr[, size]
            return _parse_int(toks[2], path, lineno), w
    raise ValueError(
        f"{path}:{lineno}: unrecognized trace line {line.strip()!r} "
        f"(expected '<addr> <R|W>' or '<tick>, <cmd>, <addr>')")


def iter_trace_requests(path: str,
                        max_requests: Optional[int] = None) -> Iterator[tuple]:
    """Lazily yield ``(addr, is_write)`` from a text trace file; ``.gz``
    files decompress transparently, and parse errors carry the real
    file:lineno."""
    seen = 0
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for lineno, line in enumerate(fh, 1):
            if max_requests is not None and seen >= max_requests:
                return
            parsed = parse_trace_line(line, path, lineno)
            if parsed is None:
                continue
            seen += 1
            yield parsed


def _empty_trace() -> Trace:
    return Trace.of(kind=np.empty(0, np.int32), bank=np.empty(0),
                    row=np.empty(0), delta=np.empty(0))


def load_trace_file(path: str, geo: Geometry, delta: int = 8,
                    window_dep: int = 0, llc: Optional[LLC] = None,
                    max_requests: Optional[int] = None) -> Trace:
    """Parse a whole ramulator-/MemTraceProbe-style text trace (plain or
    gzip ``.gz``) into one :class:`Trace` via
    :func:`dram_trace_from_stream`. ``llc`` (an optional cache model)
    filters the CPU-level stream down to DRAM traffic first. For files
    too large to materialize, use :func:`iter_trace_file_windows` with
    the streaming driver."""
    pairs = list(iter_trace_requests(path, max_requests))
    if not pairs:
        return _empty_trace()
    addrs = np.array([a for a, _ in pairs], np.int64)
    writes = np.array([w for _, w in pairs], bool)
    if llc is not None:
        addrs, writes, _ = filter_stream(addrs, writes, llc)
        if len(addrs) == 0:
            return _empty_trace()
    return dram_trace_from_stream(addrs, writes, geo, delta=delta,
                                  window_dep=window_dep)


def iter_trace_file_windows(path: str, geo: Geometry, window: int = 4096,
                            delta: int = 8, window_dep: int = 0,
                            llc: Optional[LLC] = None,
                            max_requests: Optional[int] = None,
                            ) -> Iterator[Trace]:
    """Windowed :func:`load_trace_file` for the streaming driver: reads
    ``window`` requests at a time and yields each batch as a
    :class:`Trace`, in O(window) memory. A given ``llc`` is stateful
    across windows (one object filters the whole stream), so the
    concatenated output equals :func:`load_trace_file`; windows come out
    shorter where the cache absorbs accesses."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    addrs, writes = [], []

    def flush():
        a = np.array(addrs, np.int64)
        w = np.array(writes, bool)
        addrs.clear()
        writes.clear()
        if llc is not None:
            a, w, _ = filter_stream(a, w, llc)
        if len(a) == 0:
            return None
        return dram_trace_from_stream(a, w, geo, delta=delta,
                                      window_dep=window_dep)

    for addr, is_write in iter_trace_requests(path, max_requests):
        addrs.append(addr)
        writes.append(is_write)
        if len(addrs) == window:
            tr = flush()
            if tr is not None:
                yield tr
    if addrs:
        tr = flush()
        if tr is not None:
            yield tr


def synthetic_stream(n_requests: int, window: int = 4096, seed: int = 0,
                     n_banks: int = 16, n_rows: int = 4096,
                     kinds: int = 2, delta_max: int = 8,
                     dep_max: int = 2) -> Iterator[Trace]:
    """A random request stream, yielded one ``window`` at a time so the
    whole trace never materializes. Window k draws from
    ``RandomState((seed * 1_000_003 + k) % 2**31)``, so the stream is
    reproducible and restartable: uniform banks and rows, a read/write
    mix, delta in [1, delta_max), dep in [0, dep_max)."""
    emitted = 0
    k = 0
    while emitted < n_requests:
        m = min(window, n_requests - emitted)
        rng = np.random.RandomState((seed * 1_000_003 + k) % (2 ** 31))
        yield Trace.of(kind=rng.randint(0, kinds, m),
                       bank=rng.randint(0, n_banks, m),
                       row=rng.randint(0, n_rows, m),
                       delta=rng.randint(1, delta_max, m),
                       dep=rng.randint(0, dep_max, m))
        emitted += m
        k += 1


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


def rowhammer_trace(n_requests: int, geo: Geometry, hammer_row: int = 128,
                    hammer_bank: int = 0, intensity: float = 0.8,
                    double_sided: bool = True, seed: int = 0,
                    delta_max: int = 8) -> Trace:
    """Aggressor-access storm for the fault model (``core.faults``): a
    fraction ``intensity`` of the requests are READs that alternate
    between ``hammer_row`` and ``hammer_row + 2`` (both neighbour the
    victim ``hammer_row + 1``; single-sided alternates with a far decoy
    row) on ``hammer_bank``, so every hammer is a row activation; the rest
    are uniform background traffic on the other banks. Deterministic in
    ``seed``; ``intensity`` is the sweep axis of
    ``techniques.RowHammerMitigationStudy``."""
    if not 0.0 <= intensity <= 1.0:
        raise ValueError(f"intensity must be in [0, 1], got {intensity}")
    rng = np.random.RandomState(seed)
    hammer = rng.rand(n_requests) < intensity
    alt = np.cumsum(hammer) % 2
    other = hammer_row + 2 if double_sided \
        else (hammer_row + geo.n_rows // 2) % geo.n_rows
    row = np.where(hammer, np.where(alt == 0, hammer_row, other),
                   rng.randint(0, geo.n_rows, n_requests))
    bg_bank = (hammer_bank + rng.randint(1, max(2, geo.n_banks),
                                         n_requests)) % geo.n_banks
    bank = np.where(hammer, hammer_bank, bg_bank)
    kind = np.where(hammer, READ, rng.randint(0, 2, n_requests))
    return Trace.of(kind=kind.astype(np.int32), bank=bank, row=row,
                    delta=rng.randint(1, delta_max, n_requests),
                    dep=np.zeros(n_requests, np.int32))


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


# ---------------- LM-step traces ----------------

def lm_decode_trace(cfg, seq_len: int, geo: Geometry, max_requests=20000,
                    hbm_like_delta=2):
    """DRAM traffic of one decode step: stream the active parameters, then
    the KV reads. Weight rows are touched in order across the banks, KV
    reads scatter over the upper half of the rows. The parameters are
    counted from the port's model definitions
    (``models.model_zoo.build(cfg).n_params()``): a family whose layers
    the port does not build yet raises ``NotImplementedError`` there."""
    from repro_torch.models import model_zoo
    model = model_zoo.build(cfg, s_max=max(seq_len, 16))
    n_params = model.n_params()
    if cfg.moe:
        act_frac = (cfg.moe.top_k / cfg.moe.n_experts)
        n_active = int(n_params * (0.25 + 0.75 * act_frac))
    else:
        n_active = n_params
    weight_rows = min(n_active * 2 // geo.row_bytes, max_requests * 3 // 4)
    kv_lines = 0
    if not cfg.attn_free:
        attn_layers = max(cfg.n_layers // cfg.attn_every, 1)
        kv_bytes = (attn_layers * 2 * cfg.n_kv_heads *
                    cfg.resolved_head_dim * seq_len * 2)
        kv_lines = min(kv_bytes // geo.line_bytes, max_requests // 4)
    kinds, banks, rows, deltas = [], [], [], []
    for i in range(int(weight_rows)):
        kinds.append(READ)
        banks.append(i % geo.n_banks)
        rows.append((i // geo.n_banks) % geo.n_rows)
        deltas.append(hbm_like_delta)
    rng = np.random.RandomState(3)
    for i in range(int(kv_lines)):
        kinds.append(READ)
        banks.append(int(rng.randint(geo.n_banks)))
        rows.append(int(rng.randint(geo.n_rows // 2, geo.n_rows)))
        deltas.append(hbm_like_delta)
    return Trace.of(kinds, banks, rows, deltas)


def kv_fork_trace(n_pages: int, page_bytes: int, geo: Geometry, mode: str,
                  device=None):
    """A KV-cache page fork (prefix sharing, a beam split) as a bulk copy:
    the serving side's RowClone use case. ``device`` is the DRAM device
    model (``core.profiling.DeviceModel``), as in :func:`copy_workload`."""
    return copy_workload(n_pages * page_bytes, geo, mode=mode, device=device,
                         setting="noflush", alloc_base_row=16384)
