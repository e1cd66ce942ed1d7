"""DRAM techniques as software-memory-controller extensions (Secs. 7-8).

``RowClone`` (in-DRAM bulk copy / initialization, with profiling-driven
CPU fallback), ``TRCDReduction`` (characterize weak rows, key a Bloom
filter with them, serve every other row at reduced tRCD) and
``RowHammerMitigationStudy`` (mitigation programs against the fault
model's flips). Each evaluates through one
:class:`~repro_torch.core.campaign.Campaign`: one batched engine call per
group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import smcprog, traces
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.campaign import Campaign, Point
from repro_torch.core.faults import FaultModel
from repro_torch.core.profiling import DeviceModel
from repro_torch.core.smcprog import PolicyProgram
from repro_torch.core.timescale import SystemConfig


@dataclasses.dataclass
class RowCloneResult:
    mode: str
    setting: str
    n_bytes: int
    exec_cycles: int
    exec_seconds: float
    fallback_rows: int
    speedup_vs_cpu: float = 0.0


class RowClone:
    """In-DRAM bulk copy/initialization (Sec. 7)."""

    def __init__(self, sys: SystemConfig, device: Optional[DeviceModel] = None):
        self.sys = sys
        self.geo = sys.geometry
        self.device = device or DeviceModel(self.geo)

    def evaluate(self, n_bytes: int, workload: str = "copy",
                 setting: str = "noflush", mode_ts: str = "ts",
                 cpu_line_delta: int = None, device=None):
        """Returns {'cpu': RowCloneResult, 'rowclone': RowCloneResult}."""
        return self.evaluate_batch([n_bytes], workload, setting, mode_ts,
                                   cpu_line_delta, device)[0]

    def evaluate_batch(self, sizes: Sequence[int], workload: str = "copy",
                       setting: str = "noflush", mode_ts: str = "ts",
                       cpu_line_delta: int = None,
                       device=None) -> List[dict]:
        """Sweep ``sizes`` in one campaign (cpu and rowclone arm per size).
        ``device`` is the engine's torch device (None = CUDA), not the
        DRAM device model ``self.device``. Returns one {'cpu',
        'rowclone'} dict per size, in order."""
        gen = traces.copy_workload if workload == "copy" else traces.init_workload
        kw = {} if cpu_line_delta is None else {"cpu_line_delta": cpu_line_delta}
        sizes = list(sizes)
        c = Campaign()
        fallbacks = {}
        for j, nb in enumerate(sizes):
            for arm in ("cpu", "rowclone"):
                tr, meta = gen(nb, self.geo, mode=arm, device=self.device,
                               setting=setting, **kw)
                c.add(tr, self.sys, mode=mode_ts, j=j, arm=arm)
                fallbacks[(j, arm)] = meta["fallback_rows"]
        recs = {(r["j"], r["arm"]): r for r in c.run(device=device)}
        out = []
        for j, nb in enumerate(sizes):
            d = {}
            for arm in ("cpu", "rowclone"):
                r = recs[(j, arm)]
                d[arm] = RowCloneResult(
                    mode=arm, setting=setting, n_bytes=nb,
                    exec_cycles=int(r["exec_cycles"]),
                    exec_seconds=r["exec_seconds"],
                    fallback_rows=fallbacks[(j, arm)])
            d["rowclone"].speedup_vs_cpu = \
                d["cpu"].exec_cycles / max(d["rowclone"].exec_cycles, 1)
            out.append(d)
        return out


class TRCDReduction:
    """Reduced-tRCD access via characterization + Bloom filter (Sec. 8)."""

    def __init__(self, sys: SystemConfig, device: Optional[DeviceModel] = None,
                 m_bits: int = 1 << 20, k: int = 4):
        self.sys = sys
        self.geo = sys.geometry
        self.device = device or DeviceModel(self.geo)
        self.m_bits = m_bits
        self.k = k
        self._bloom: Optional[BloomFilter] = None

    def characterize(self) -> BloomFilter:
        """Profile rows (the device model) and key the filter with the
        weak ones."""
        weak = self.device.weak_rows()
        self._bloom = BloomFilter.build(weak, m_bits=self.m_bits, k=self.k)
        return self._bloom

    @property
    def bloom_tuple(self):
        if self._bloom is None:
            self.characterize()
        b = self._bloom
        return (b.bits, b.k, b.m_bits)

    def safety_check(self, n=100000, seed=1):
        """No weak row may probe negative (zero false negatives)."""
        if self._bloom is None:
            raise ValueError("call characterize() first")
        weak = self.device.weak_rows()
        miss = (~self._bloom.contains(weak)).sum()
        rng = np.random.RandomState(seed)
        probe = rng.randint(0, self.geo.n_banks * self.geo.n_rows, n)
        truth = self.device.weak.reshape(-1)[probe]
        fpr = self._bloom.false_positive_rate(probe, truth)
        return {"false_negatives": int(miss), "false_positive_rate": float(fpr)}

    def evaluate_trace(self, trace, mode_ts: str = "ts", device=None):
        """Run a workload with and without reduced-tRCD scheduling."""
        return self.evaluate_traces([trace], mode_ts, device)[0]

    def evaluate_traces(self, trs: Sequence, mode_ts: str = "ts",
                        device=None) -> List[dict]:
        """Base-vs-reduced sweep through one campaign; per-trace dicts in
        input order. ``device``: the engine's torch device (None = CUDA)."""
        bloom = self.bloom_tuple
        c = Campaign()
        for i, tr in enumerate(trs):
            c.add(tr, self.sys, mode=mode_ts, i=i, arm="base")
            c.add(tr, self.sys, mode=mode_ts, bloom=bloom, i=i, arm="reduced")
        arms = {(r["i"], r["arm"]): int(r["exec_cycles"])
                for r in c.run(device=device)}
        return [{
            "base_cycles": arms[(i, "base")],
            "reduced_cycles": arms[(i, "reduced")],
            "speedup": arms[(i, "base")] / max(arms[(i, "reduced")], 1),
        } for i in range(len(trs))]


class RowHammerMitigationStudy:
    """RowHammer mitigations as memory-controller programs, judged end to
    end under the fault model: each (program x hammer intensity) point
    replays a :func:`traces.rowhammer_trace` storm under one
    :class:`FaultModel`, and the record pairs its bit-error rate with the
    program's slowdown against the unmitigated baseline.

    Programs default to :func:`smcprog.mitigation_programs` tuned to the
    fault model: ``frfcfs`` (no mitigation: the baseline), PARA at ~5% per
    activation and TRR at half the hammer threshold. ``derive_cost``
    charges each program its length-derived decision cost."""

    def __init__(self, sys: SystemConfig,
                 fault_model: Optional[FaultModel] = None,
                 programs: Optional[Dict[str, PolicyProgram]] = None,
                 baseline: str = "frfcfs"):
        self.sys = sys
        self.geo = sys.geometry
        self.fault_model = fault_model if fault_model is not None else \
            FaultModel(seed=7, hammer_threshold=48, hammer_flip_fp=52000)
        # TRR must trigger below the hammer threshold or it never fires
        self.programs = dict(programs) if programs is not None \
            else smcprog.mitigation_programs(
                para_fp=3277,
                trr_threshold=max(1, self.fault_model.hammer_threshold // 2))
        if baseline not in self.programs:
            raise ValueError(
                f"baseline {baseline!r} not among programs "
                f"{sorted(self.programs)}")
        self.baseline = baseline

    def evaluate(self, intensities: Sequence[float] = (0.45, 0.9),
                 n_requests: int = 480, mode: str = "ts", seed: int = 0,
                 derive_cost: bool = True, policy_axis: bool = True,
                 device=None, **run_kw) -> List[dict]:
        """One record per intensity, in order: ``{'intensity': f,
        <program>: {bit_error_rate, flips, mitigations, exec_cycles,
        exec_seconds, slowdown_vs_unmitigated}}``, all points in one
        campaign. ``policy_axis=True`` carries each program as a runtime
        table (one group per table bucket), ``False`` attaches it to the
        config (one group per program). ``device`` is the engine's (None =
        CUDA); the campaign takes no other run option yet (checkpointing
        is ROADMAP Queue A 9)."""
        if run_kw:
            raise NotImplementedError(
                f"Campaign.run options {sorted(run_kw)}: the port's "
                f"campaign takes only device= (checkpoint and on_error are "
                f"ROADMAP Queue A 9)")
        c = Campaign()
        sysf = self.sys.with_faults(self.fault_model)
        for i, inten in enumerate(intensities):
            tr = traces.rowhammer_trace(n_requests, self.geo,
                                        intensity=float(inten),
                                        seed=seed + i)
            for name, prog in self.programs.items():
                if policy_axis:
                    cost = prog.smc_cycles() if derive_cost \
                        else int(self.sys.smc_cycles_per_decision)
                    # the dict key labels the record; mixed table buckets
                    # fork into per-bucket groups
                    c.points.append(Point(
                        tr, sysf, mode, None, {"mitigation": name, "i": i},
                        policy=prog, policy_cost=cost))
                    continue
                sysc = self.sys.with_policy(prog) if derive_cost \
                    else dataclasses.replace(self.sys, policy=prog)
                c.add(tr, sysc.with_faults(self.fault_model), mode,
                      mitigation=name, i=i)
        recs = {(r["i"], r["mitigation"]): r for r in c.run(device=device)}
        out: List[dict] = []
        for i, inten in enumerate(intensities):
            base = int(recs[(i, self.baseline)]["exec_cycles"])
            d: dict = {"intensity": float(inten)}
            for name in self.programs:
                r = recs[(i, name)]
                d[name] = {
                    "bit_error_rate": float(r["bit_error_rate"]),
                    "flips": int(r["flips"]),
                    "mitigations": int(r["mitigations"]),
                    "exec_cycles": int(r["exec_cycles"]),
                    "exec_seconds": float(r["exec_seconds"]),
                    "slowdown_vs_unmitigated":
                        int(r["exec_cycles"]) / max(base, 1),
                }
            out.append(d)
        return out
