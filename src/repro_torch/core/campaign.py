"""Batched emulation campaigns over (workload x system x mode x technique).

A :class:`Campaign` collects a grid of points, groups them by
:func:`repro_torch.core.emulator.group_key` (trace-length bucket,
``SystemConfig``, normalized mode, Bloom-filter shape, policy-table
bucket), runs each group as ONE :func:`~repro_torch.core.emulator.run_many`
call, in order, and returns per-point records in ``add`` order, each
with the point's extra keyword arguments merged in.

Usage::

    c = Campaign()
    for name, tr in traces.items():
        c.add(tr, JETSON_NANO, mode="ts", workload=name)
        c.add(tr, JETSON_NANO, mode="ts", bloom=bloom, workload=name,
              technique="trcd")
    records = c.run()          # [{workload, technique, exec_cycles, ...}]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import emulator
from repro_torch.core.emulator import Trace
from repro_torch.core.smcprog import PolicyProgram, table_bucket
from repro_torch.core.timescale import SystemConfig


@dataclasses.dataclass
class Point:
    """One grid point. ``meta`` is carried through to the result."""
    trace: Trace
    sys: SystemConfig
    mode: str = "ts"
    bloom: Optional[tuple] = None       # (words_u32, k, m_bits)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # runtime policy axis: the program rides the batch as data
    policy: Optional[PolicyProgram] = None
    policy_cost: Optional[int] = None   # smc_cycles_per_decision operand

    def group_key(self) -> tuple:
        return emulator.group_key(self.trace.n, self.sys, self.mode,
                                  self.bloom, policy=self.policy)


class Campaign:
    """Collect grid points, execute them in compile-key groups."""

    def __init__(self) -> None:
        self.points: List[Point] = []

    def add(self, trace: Trace, sys: SystemConfig, mode: str = "ts",
            bloom: Optional[tuple] = None, **meta) -> "Campaign":
        emulator.check_mode(mode)
        if not isinstance(trace, Trace):
            raise ValueError(f"points need a Trace, got "
                             f"{type(trace).__name__}")
        self.points.append(Point(trace, sys, mode, bloom, meta))
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

    def run(self, device=None) -> List[dict]:
        """Execute every point, one batched ``run_many`` per group, in
        group order; records come back in ``add`` order."""
        dev = emulator.resolve_device(device)
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(self.points):
            groups.setdefault(p.group_key(), []).append(i)
        results: List[Optional[dict]] = [None] * len(self.points)
        for idxs in groups.values():
            pts = [self.points[i] for i in idxs]
            p0 = pts[0]
            blooms = None
            if p0.bloom is not None:
                # one shared filter broadcasts; distinct ones stack
                same = all(p.bloom is p0.bloom for p in pts)
                blooms = p0.bloom if same else [p.bloom for p in pts]
            pkw = {} if p0.policy is None else dict(
                policies=[p.policy for p in pts],
                policy_costs=[p.policy_cost for p in pts])
            outs = emulator.run_many([p.trace for p in pts], p0.sys,
                                     [p.mode for p in pts], blooms,
                                     device=dev, **pkw)
            for p, i, out in zip(pts, idxs, outs):
                clash = set(out) & set(p.meta)
                if clash:
                    raise ValueError(
                        f"meta keys shadow emulator result fields: "
                        f"{sorted(clash)}")
                results[i] = {**out, **p.meta}
        return results
