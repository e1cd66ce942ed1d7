"""The port's Campaign and the paper's two case studies (``device="cpu"``)
against the JAX package in one process, on the same seeded inputs, exactly
on every int output and the host-derived floats."""
import dataclasses

import pytest
import torch

from repro.core import emulator as je, smcprog as jsmc
from repro.core import techniques as jtech, traces as jtraces
from repro.core.campaign import Campaign as JCampaign
from repro.core.timescale import JETSON_NANO as JN

from repro_torch.core import techniques as ptech, traces as ptraces
from repro_torch.core.campaign import Campaign as PCampaign
from repro_torch.core.dram import Geometry as PGeometry
from repro_torch.core.profiling import DeviceModel as PDevice

from test_torch_engine import (CPU, assert_same, grid_trace, pair,
                               port_prog, port_sys, trace_bloom)

torch.set_num_threads(1)


def test_campaign_grid_matches_jax():
    """ts / reference / nots and bloom arms in one campaign; ts equals
    reference exactly, in both packages."""
    arrs = [grid_trace(50 + s, 55 + 5 * s, kinds=2) for s in range(2)]
    bloom = trace_bloom(arrs)
    trs = [pair(a) for a in arrs]
    jc, pc = JCampaign(), PCampaign()
    for i, (jt, pt) in enumerate(trs):
        for mode in ("ts", "reference", "nots"):
            jc.add(jt, JN, mode=mode, i=i, arm="plain")
            pc.add(pt, port_sys(JN), mode=mode, i=i, arm="plain")
        for mode in ("ts", "reference"):
            jc.add(jt, JN, mode=mode, bloom=bloom, i=i, arm="bloom")
            pc.add(pt, port_sys(JN), mode=mode, bloom=bloom, i=i, arm="bloom")
    assert jc.n_groups() == pc.n_groups()
    a, b = jc.run(serial=True), pc.run(device=CPU)
    for x, y in zip(a, b):
        assert (x["i"], x["arm"]) == (y["i"], y["arm"])
        assert_same(x, y, f"{y['i']}/{y['arm']}/{y['mode']}")
    by = {(r["i"], r["arm"], r["mode"]): int(r["exec_cycles"]) for r in b}
    for i in range(2):
        for arm in ("plain", "bloom"):
            assert by[(i, arm, "ts")] == by[(i, arm, "reference")]


@pytest.mark.parametrize("policy_axis", [True, False])
def test_add_policy_grid_matches_jax(policy_axis):
    progs = list(jsmc.builtin_programs().values())[1:3]
    jt, pt = pair(grid_trace(61, 50))
    jc, pc = JCampaign(), PCampaign()
    jc.add_policy_grid(jt, JN, progs, mode="nots", policy_axis=policy_axis)
    pc.add_policy_grid(pt, port_sys(JN), [port_prog(p) for p in progs],
                       mode="nots", policy_axis=policy_axis)
    assert jc.n_groups() == pc.n_groups()
    for x, y in zip(jc.run(serial=True), pc.run(device=CPU)):
        assert x["policy"] == y["policy"]
        assert_same(x, y, y["policy"])


def test_trcd_reduction_matches_jax():
    """The Sec. 8 flow on a small geometry: characterization, the Bloom
    filter, zero false negatives, and base vs reduced cycles."""
    jsys = dataclasses.replace(
        JN, geometry=je.dram.Geometry(n_banks=16, n_rows=4096))
    psys = port_sys(jsys)
    jt = jtech.TRCDReduction(jsys, m_bits=1 << 14)
    pt = ptech.TRCDReduction(psys, PDevice(psys.geometry), m_bits=1 << 14)
    assert jt.characterize().bits.tobytes() == pt.characterize().bits.tobytes()
    assert jt.safety_check(n=2000) == pt.safety_check(n=2000)
    assert pt.safety_check(n=2000)["false_negatives"] == 0
    jtr, ptr = [], []
    for idx in (0, 12):
        a, _ = jtraces.polybench_trace(jtraces.POLYBENCH[idx], jsys.geometry,
                                       max_accesses=100)
        b, _ = ptraces.polybench_trace(ptraces.POLYBENCH[idx], psys.geometry,
                                       max_accesses=100)
        jtr.append(a)
        ptr.append(b)
    assert jt.evaluate_traces(jtr) == pt.evaluate_traces(ptr, device=CPU)


@pytest.mark.parametrize("workload", ["copy", "init"])
def test_rowclone_matches_jax(workload):
    jr = jtech.RowClone(JN).evaluate_batch([2048, 4096], workload=workload)
    pr = ptech.RowClone(port_sys(JN), PDevice(PGeometry())).evaluate_batch(
        [2048, 4096], workload=workload, device=CPU)
    for a, b in zip(jr, pr):
        for arm in ("cpu", "rowclone"):
            assert dataclasses.asdict(a[arm]) == dataclasses.asdict(b[arm])
