"""Batched emulation campaigns over (workload x system x mode x technique).

A :class:`Campaign` collects a grid of points, groups them by
:func:`repro_torch.core.emulator.group_key` (trace-length bucket,
``SystemConfig``, normalized mode, Bloom-filter shape, policy-table
bucket), prepares each group as the tasks of one batched engine call
(``emulator.prepare_tasks``), runs them all through
``repro_torch.core.executor`` (overlapped across its workers, each on its
own CUDA stream; ``run(serial=True)`` keeps the in-order loop) and
returns per-point records in ``add`` order, each with the point's extra
keyword arguments merged in.

Usage::

    c = Campaign()
    for name, tr in traces.items():
        c.add(tr, JETSON_NANO, mode="ts", workload=name)
        c.add(tr, JETSON_NANO, mode="ts", bloom=bloom, workload=name,
              technique="trcd")
    records = c.run()          # [{workload, technique, exec_cycles, ...}]

Unbounded workloads are one more grid axis: ``add(stream, sys,
stream=True, chunk=...)`` takes an iterable (or generator factory) of
``Trace`` windows and runs it through ``emulator.run_stream_many``, the
constant-memory window driver. Stream points group on ``(chunk, sys,
mode, bloom-shape)``, whatever their length.

Fault tolerance: ``run(checkpoint=dir)`` persists each completed group's
results, content-addressed, the moment its task finalizes, and a rerun
loads them and launches nothing for them; ``run(on_error='quarantine')``
returns a failed group's points as error records while every other group
completes; ``timeout`` / ``retries`` pass through to the executor.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import emulator, executor
from repro_torch.core.emulator import Trace
from repro_torch.core.smcprog import PolicyProgram, pack_program, table_bucket
from repro_torch.core.timescale import SystemConfig


@dataclasses.dataclass
class Point:
    """One grid point. ``meta`` is carried through to the result.

    ``stream=True`` marks an unbounded point: ``trace`` is then a Trace,
    an iterable of Trace windows, or a zero-arg callable returning one,
    run through ``emulator.run_stream_many`` in windows of ``chunk``
    requests."""
    trace: Any
    sys: SystemConfig
    mode: str = "ts"
    bloom: Optional[tuple] = None       # (words_u32, k, m_bits)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stream: bool = False
    chunk: Optional[int] = None         # stream window size (stream only)
    # runtime policy axis: the program rides the batch as data
    policy: Optional[PolicyProgram] = None
    policy_cost: Optional[int] = None   # smc_cycles_per_decision operand
    # memoized content_digest(), not part of identity or comparisons
    _digest: Optional[str] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def content_digest(self) -> str:
        """sha1 hex digest of the point's result-relevant content: the
        mode, every trace array, the Bloom words and parameters and the
        runtime policy's packed table and cost (``meta`` is excluded: it
        is merged back at the end). The same bytes as the reference's, so
        the same digest for the same point. Memoized: points are treated
        as immutable after ``add``. Stream points have no content address
        (one-shot iterators) and raise."""
        if self.stream:
            raise ValueError(
                "stream points have no content digest (their input is a "
                "one-shot iterator); checkpointing skips them")
        if self._digest is None:
            h = hashlib.sha1()
            h.update(self.mode.encode())
            for f in ("kind", "bank", "row", "delta", "dep"):
                h.update(np.ascontiguousarray(
                    np.asarray(getattr(self.trace, f), np.int32)).tobytes())
            if self.bloom is not None:
                h.update(np.ascontiguousarray(
                    np.asarray(self.bloom[0])).tobytes())
                h.update(repr((int(self.bloom[1]),
                               int(self.bloom[2]))).encode())
            if self.policy is not None:
                # two points with one trace but different runtime policies
                # never share a checkpoint address
                h.update(np.ascontiguousarray(
                    pack_program(self.policy)).tobytes())
                h.update(repr(int(self.policy_cost or 0)).encode())
            self._digest = h.hexdigest()
        return self._digest

    def group_key(self) -> tuple:
        if self.stream:
            # no length bucket: stream points group on (chunk, sys, mode,
            # bloom-shape) alone, whatever their size
            chunk = self.chunk or emulator.DEFAULT_STREAM_CHUNK
            return ("stream", chunk, self.sys,
                    emulator._norm_mode(self.mode),
                    emulator._bloom_shape(self.bloom))
        return emulator.group_key(self.trace.n, self.sys, self.mode,
                                  self.bloom, policy=self.policy)


def _group_digest(key: tuple, pts: Sequence[Point]) -> str:
    """Content address of one group's results: the group key (system
    config, mode, shapes; policy and fault model through the config) plus
    every member's :meth:`Point.content_digest`, in group order. A stale
    or foreign checkpoint can only collide by content, not by position."""
    h = hashlib.sha1()
    h.update(repr(key).encode())
    for p in pts:
        h.update(p.content_digest().encode())
    return h.hexdigest()[:16]


def _checkpointed(orig_finalize, outs: List[Optional[dict]], path: str):
    """Wrap a task's ``finalize`` so that the group's result list is saved
    the moment its last slot lands, atomically (a temporary file, then
    ``os.replace``: a kill mid-write leaves no half file, the group just
    runs again). Concurrent finalizers can at worst both write identical
    bytes, and ``os.replace`` keeps one whole."""
    def finalize(out, ctx):
        orig_finalize(out, ctx)
        if all(o is not None for o in outs):
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                pickle.dump(outs, fh, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
    return finalize


class Campaign:
    """Collect grid points, execute them in compile-key groups.

    ``run(checkpoint=dir)`` persists each completed group's results and
    resumes a killed sweep with nothing recomputed;
    ``run(on_error='quarantine')`` isolates failing groups instead of
    abandoning the sweep. ``last_run`` reports what happened."""

    def __init__(self) -> None:
        self.points: List[Point] = []
        # the most recent run(): group counts by outcome plus the
        # executor's TaskFailure records (empty before any run)
        self.last_run: Dict[str, Any] = {}

    def add(self, trace, sys: SystemConfig, mode: str = "ts",
            bloom: Optional[tuple] = None, stream: bool = False,
            chunk: Optional[int] = None, **meta) -> "Campaign":
        emulator.check_mode(mode)
        if not stream and not isinstance(trace, Trace):
            raise ValueError(
                f"non-stream points need a Trace, got "
                f"{type(trace).__name__}; pass stream=True for "
                f"iterables / generator factories")
        if chunk is not None and not stream:
            raise ValueError("chunk is a stream-point knob; pass stream=True")
        self.points.append(Point(trace, sys, mode, bloom, meta,
                                 stream=stream, chunk=chunk))
        return self

    def extend(self, traces: Sequence[Trace], sys: SystemConfig,
               mode: str = "ts", bloom: Optional[tuple] = None,
               metas: Optional[Sequence[dict]] = None) -> "Campaign":
        traces = list(traces)
        metas = [{}] * len(traces) if metas is None else list(metas)
        if len(metas) != len(traces):
            raise ValueError(
                f"metas ({len(metas)}) must match traces ({len(traces)})")
        for tr, m in zip(traces, metas):
            self.add(tr, sys, mode, bloom, **m)
        return self

    def add_policy_grid(self, trace: Trace, sys: SystemConfig,
                        programs: Sequence[PolicyProgram], mode: str = "ts",
                        derive_cost: bool = True, policy_axis: bool = True,
                        **meta) -> "Campaign":
        """One point per program (records carry ``policy=<name>``).
        ``derive_cost`` charges each program its length-derived cost.
        ``policy_axis=True`` rides the runtime table (one group for a
        shared table bucket; mixed buckets raise); ``False`` attaches each
        program to ``sys`` (one group per program)."""
        emulator.check_mode(mode)
        names = [p.name for p in programs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"policy grid needs unique program names (records key "
                f"on them), got duplicates {dupes}")
        if not isinstance(trace, Trace):
            raise ValueError(
                f"policy grids need a Trace, got {type(trace).__name__}")
        if "policy" in meta:
            raise ValueError(
                "meta key 'policy' is reserved for the program name")
        if not policy_axis:
            for prog in programs:
                sysc = sys.with_policy(prog) if derive_cost \
                    else dataclasses.replace(sys, policy=prog)
                self.add(trace, sysc, mode, policy=prog.name, **meta)
            return self
        buckets = {p.name: table_bucket(p.n_ops) for p in programs}
        lb = min(buckets.values(), default=None)
        for prog in programs:
            if buckets[prog.name] != lb:
                raise ValueError(
                    f"policy_axis=True needs one shared table-length "
                    f"bucket, but program {prog.name!r} ({prog.n_ops} "
                    f"ops) packs to bucket {buckets[prog.name]} while "
                    f"others pack to {lb}; split the grid by bucket or "
                    f"pass policy_axis=False")
        for prog in programs:
            cost = prog.smc_cycles() if derive_cost \
                else int(sys.smc_cycles_per_decision)
            self.points.append(Point(
                trace, sys, mode, None, {"policy": prog.name, **meta},
                policy=prog, policy_cost=cost))
        return self

    def __len__(self) -> int:
        return len(self.points)

    def n_groups(self) -> int:
        return len({p.group_key() for p in self.points})

    def run(self, serial: Optional[bool] = None,
            stream_collect: str = "aggregate",
            checkpoint: Optional[str] = None, on_error: str = "raise",
            timeout: Optional[float] = None, retries: Optional[int] = None,
            device=None) -> List[dict]:
        """Execute every point; one batched engine call per group.

        Every group is prepared up front (on this thread) and the tasks run
        overlapped across the ``core.executor`` workers, each on its own
        CUDA stream: one group's host packing proceeds while another's
        scan runs, and independent groups' scans run side by side on the
        card. ``serial=True`` keeps the in-order loop on this thread; the
        default also falls back to it for a single group, a one-worker
        pool or the CPU (``executor.execute``). Records are equal either
        way, in ``add`` order: the engine's result dict plus the point's
        ``meta``. Stream points run through the window loop as their own
        tasks on the same pool;
        ``stream_collect`` is their output shape ('aggregate', the default,
        keeps no per-request arrays; 'full').

        * ``checkpoint=<dir>`` saves each completed group's result list as
          ``group-<digest>.pkl`` the moment its task finalizes, where the
          digest is the group's content address (:func:`_group_digest`).
          A rerun with the same directory loads finished groups, launches
          nothing for them and gives the same records. Stream groups are
          never checkpointed: their inputs are one-shot iterators.
        * ``on_error='quarantine'``: a failing group is recorded
          (``last_run['failures']``) and its points come back as error
          records (``{'error', 'error_type', 'group', **meta}``) while
          every other group completes. The default ``'raise'`` raises the
          executor's :class:`~repro_torch.core.executor.ExecutionError`
          after the completed groups have been checkpointed.
        * ``timeout`` / ``retries`` pass through to
          :func:`~repro_torch.core.executor.execute`.
        * ``device`` is the engine's torch device (None = CUDA).

        ``self.last_run`` gets ``{'groups', 'loaded', 'computed',
        'failed', 'failures'}`` either way."""
        if on_error not in ("raise", "quarantine"):
            raise ValueError(
                f"on_error must be 'raise' or 'quarantine', got {on_error!r}")
        dev = emulator.resolve_device(device)
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(self.points):
            groups.setdefault(p.group_key(), []).append(i)
        if checkpoint is not None:
            os.makedirs(checkpoint, exist_ok=True)

        results: List[Optional[dict]] = [None] * len(self.points)
        tasks: List[Any] = []
        merges = []  # (campaign indices, points, group result list, tasks)
        loaded = 0
        for key, idxs in groups.items():
            pts = [self.points[i] for i in idxs]
            p0 = pts[0]
            ckpt_path = None
            if checkpoint is not None and not p0.stream:
                ckpt_path = os.path.join(
                    checkpoint, f"group-{_group_digest(key, pts)}.pkl")
                if os.path.exists(ckpt_path):
                    with open(ckpt_path, "rb") as fh:
                        outs = pickle.load(fh)
                    if len(outs) == len(pts) and all(
                            o is not None for o in outs):
                        loaded += 1
                        merges.append((idxs, pts, outs, []))
                        continue  # a finished group: nothing recomputed
            blooms = None
            if p0.bloom is not None:
                # one shared filter broadcasts; distinct ones stack
                same = all(p.bloom is p0.bloom for p in pts)
                blooms = p0.bloom if same else [p.bloom for p in pts]
            outs = [None] * len(pts)
            if p0.stream:
                gtasks = emulator.prepare_stream_tasks(
                    [p.trace for p in pts], p0.sys, [p.mode for p in pts],
                    blooms, outs,
                    chunk=p0.chunk or emulator.DEFAULT_STREAM_CHUNK,
                    collect=stream_collect, device=dev)
            else:
                # policy groups never mix with staged or legacy points
                # (their group key carries a fifth, policy element)
                pkw = {} if p0.policy is None else dict(
                    policies=[p.policy for p in pts],
                    policy_costs=[p.policy_cost for p in pts])
                gtasks = emulator.prepare_tasks(
                    [p.trace for p in pts], p0.sys, [p.mode for p in pts],
                    blooms, outs, device=dev, **pkw)
            if ckpt_path is not None:
                for gt in gtasks:
                    gt.finalize = _checkpointed(gt.finalize, outs, ckpt_path)
            tasks += gtasks
            merges.append((idxs, pts, outs, gtasks))

        failures = executor.execute(
            tasks, serial=serial, timeout=timeout, retries=retries,
            raise_on_error=False)
        fail_by_task = {id(f.task): f for f in failures}
        failed_groups = sum(
            1 for m in merges if any(id(t) in fail_by_task for t in m[3]))
        self.last_run = {
            "groups": len(groups), "loaded": loaded,
            "computed": len(groups) - loaded - failed_groups,
            "failed": failed_groups, "failures": failures,
        }
        if failures and on_error == "raise":
            raise executor.ExecutionError(failures)

        for idxs, pts, outs, gtasks in merges:
            gfail = next((fail_by_task[id(t)] for t in gtasks
                          if id(t) in fail_by_task), None)
            for p, i, out in zip(pts, idxs, outs):
                if out is None:
                    # quarantined: the group's task raised (or timed out)
                    # before finalizing this point
                    e = gfail.error if gfail is not None else None
                    results[i] = {
                        "error": str(e) if e is not None else "not computed",
                        "error_type": type(e).__name__ if e is not None
                        else "Unknown",
                        "group": gfail.label if gfail is not None else "",
                        **p.meta}
                    continue
                clash = set(out) & set(p.meta)
                if clash:
                    raise ValueError(
                        f"meta keys shadow emulator result fields: "
                        f"{sorted(clash)}")
                results[i] = {**out, **p.meta}
        return results
