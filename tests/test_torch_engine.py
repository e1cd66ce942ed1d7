"""The port's engine (``device="cpu"``: the plain slot-scan engine and
plain Bloom probe) against the JAX engine in one process, on the same
seeded traces: run / run_many / run_policies / Campaign and the two case
studies, exactly on every int output (and so on the host-derived
``exec_seconds`` and ``avg_load_latency_cycles``). Plus the guards: the
port imports neither JAX nor the reference package, never runs on the
CPU unasked, and refuses what it does not port yet."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import emulator as je, smcprog as jsmc
from repro.core.bloom import BloomFilter
from repro.core.policysearch import random_program
from repro.core.timescale import JETSON_NANO as JN, PIDRAM_LIKE as JPIDRAM

from repro_torch import interop
from repro_torch.core import emulator as pe
from repro_torch.core import techniques as ptech
from repro_torch.core.campaign import Campaign as PCampaign
from repro_torch.core.dram import Geometry as PGeometry
from repro_torch.core.faults import FaultModel as PFault
from repro_torch.core.profiling import DeviceModel as PDevice

torch.set_num_threads(1)

INT_FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
              "smc_fpga_cycles")
CPU = "cpu"


def port_sys(jsys):
    return interop.system_config_from_dict(dataclasses.asdict(jsys))


def port_prog(p):
    return interop.policy_from_fields(**dataclasses.asdict(p))


def pair(arrs):
    return je.Trace.of(**arrs), interop.trace_from_arrays(**arrs)


def grid_trace(seed, n, nop_run=False, kinds=5, dep_max=3):
    """Random kinds (RowClone ops and mid-trace NOPs included), banks,
    rows, compute gaps and dep chains."""
    rng = np.random.RandomState(seed)
    kind = rng.randint(0, kinds, n)
    if nop_run:
        kind[n // 3:n // 3 + 12] = 4   # a NOP run that drains the queue
    return dict(kind=kind, bank=rng.randint(0, 16, n),
                row=rng.randint(0, 256, n), delta=rng.randint(0, 24, n),
                dep=rng.randint(0, dep_max, n))


def assert_same(a, b, label=""):
    assert a["mode"] == b["mode"], label
    assert a["n_requests"] == b["n_requests"], label
    for k in INT_FIELDS:
        assert int(a[k]) == int(b[k]), (label, k)
    np.testing.assert_array_equal(a["t_resp"], b["t_resp"], err_msg=label)
    np.testing.assert_array_equal(a["t_issue"], b["t_issue"], err_msg=label)
    assert a["exec_seconds"] == b["exec_seconds"], label
    assert a["avg_load_latency_cycles"] == b["avg_load_latency_cycles"], label


def trace_bloom(arrs_list, m_bits=1 << 14, k=3):
    """A filter over every other request's global row id, so both tRCD
    arms (weak -> nominal, strong -> reduced) occur."""
    keys = np.concatenate([(a["bank"].astype(np.int64) * 32768
                            + a["row"])[::2] for a in arrs_list])
    bf = BloomFilter.build(keys.astype(np.uint32), m_bits=m_bits, k=k)
    return (bf.bits, bf.k, bf.m_bits)


@pytest.mark.parametrize("window", [1, 4, 8])
def test_run_matches_jax(window):
    sysj = dataclasses.replace(JN, window=window)
    jt, pt = pair(grid_trace(window, 90, nop_run=True))
    for mode in ("ts", "reference", "nots"):
        assert_same(je.run(jt, sysj, mode),
                    pe.run(pt, port_sys(sysj), mode, device=CPU),
                    f"{mode}/w{window}")


@pytest.mark.parametrize("scheduler,preset", [("fcfs", "jetson"),
                                              ("frfcfs", "pidram")])
def test_legacy_scheduler_flags(scheduler, preset):
    base = JN if preset == "jetson" else JPIDRAM
    sysj = dataclasses.replace(base, scheduler=scheduler)
    trs = [pair(grid_trace(s, 40 + 25 * s, dep_max=2)) for s in range(3)]
    a = je.run_many([t[0] for t in trs], sysj, "nots")
    b = pe.run_many([t[1] for t in trs], port_sys(sysj), "nots", device=CPU)
    for x, y in zip(a, b):
        assert_same(x, y, scheduler)


def test_run_many_mixed_modes_and_buckets():
    """3 traces x 3 modes over two length buckets: one group per
    (bucket, normalized mode), batches padded to powers of two."""
    trs = [pair(grid_trace(10 + s, n)) for s, n in enumerate((50, 60, 100))]
    modes = ["ts", "nots", "reference"]
    jts = [t[0] for t in trs for _ in modes]
    pts = [t[1] for t in trs for _ in modes]
    mm = modes * len(trs)
    a = je.run_many(jts, JN, mm, serial=True)
    b = pe.run_many(pts, port_sys(JN), mm, device=CPU)
    for x, y in zip(a, b):
        assert_same(x, y)


@pytest.mark.parametrize("stacked", [False, True])
def test_blooms_shared_and_per_trace(stacked):
    arrs = [grid_trace(s, 60, kinds=2) for s in range(3)]
    b1, b2 = trace_bloom(arrs), trace_bloom(arrs[1:])
    trs = [pair(a) for a in arrs]
    blooms = [b1, b2, b1] if stacked else b1
    a = je.run_many([t[0] for t in trs], JN, "ts", blooms=blooms)
    b = pe.run_many([t[1] for t in trs], port_sys(JN), "ts", blooms=blooms,
                    device=CPU)
    for x, y in zip(a, b):
        assert_same(x, y, "bloom")
    assert any(int(x["exec_cycles"]) != int(r["exec_cycles"]) for x, r in
               zip(a, je.run_many([t[0] for t in trs], JN, "ts")))


def program_pool(seed=11, n_random=4):
    rng = np.random.RandomState(seed)
    progs = list(jsmc.builtin_programs().values())
    while len(progs) < 6 + n_random:
        p = random_program(rng, name=f"r{len(progs)}")
        if not p.uses(jsmc.OP_PARA_RAND):
            progs.append(p)
    return progs


@pytest.mark.parametrize("mode", ["ts", "nots"])
@pytest.mark.parametrize("derive_cost", [True, False])
def test_run_policies_matches_jax(mode, derive_cost):
    jt, pt = pair(grid_trace(21, 70))
    progs = program_pool()
    a = je.run_policies(jt, JN, progs, mode=mode, derive_cost=derive_cost,
                        serial=True)
    b = pe.run_policies(pt, port_sys(JN), [port_prog(p) for p in progs],
                        mode=mode, derive_cost=derive_cost, device=CPU)
    for p, x, y in zip(progs, a, b):
        assert_same(x, y, p.name)


@pytest.mark.parametrize("name,mode,derived", [
    ("bank-rr", "nots", True), ("write-drain2", "nots", False),
    ("open-page", "ts", True)])
def test_staged_programs_match_jax(name, mode, derived):
    """A program attached to the config runs through the table VM with
    the config's decision cost (``with_policy`` derives it)."""
    prog = jsmc.builtin_programs()[name]
    sysj = JN.with_policy(prog) if derived \
        else dataclasses.replace(JN, policy=prog)
    jt, pt = pair(grid_trace(31, 60))
    assert_same(je.run(jt, sysj, mode),
                pe.run(pt, port_sys(sysj), mode, device=CPU), name)


def test_mixed_table_buckets_and_trr_on_a_perfect_memory():
    """A 21-op program (bucket 32) beside bucket-8 programs, and TRR,
    whose hammer counter reads zero without a fault model."""
    b = jsmc.PolicyBuilder()
    v = b.score_age()
    for _ in range(10):
        v = b.add(v, b.const(1))
    progs = [b.build(score=v, name="long21"), jsmc.trr_program(4),
             jsmc.fcfs_program()]
    jt, pt = pair(grid_trace(41, 50))
    a = je.run_policies(jt, JN, progs, mode="nots", serial=True)
    b_ = pe.run_policies(pt, port_sys(JN), [port_prog(p) for p in progs],
                         mode="nots", device=CPU)
    for p, x, y in zip(progs, a, b_):
        assert_same(x, y, p.name)


def test_state_from_host_accepts_jax_state():
    jst = je.EmulatorState.init(20, JN)
    st = interop.EmulatorState.from_host(jst.to_host())
    assert st.queue.tolist() == [-1] * 4
    assert int(st.last_bank) == -1 and st.t_resp.shape == (20,)


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, imported in a fresh interpreter, pulls
    in no jax and no module of the reference package."""
    root = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    """Without a CUDA device, the default device (CUDA) raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt = pair(grid_trace(0, 20))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.run(pt, port_sys(JN))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCampaign().add(pt, port_sys(JN)).run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptech.RowClone(port_sys(JN), PDevice(PGeometry(n_rows=4096))) \
            .evaluate_batch([4096])


def test_unported_features_raise():
    """Fault injection is ported (tests/test_torch_faults.py), and so are
    the campaign's run options (tests/test_torch_executor.py): the study
    passes them to ``Campaign.run``, which refuses a bad ``on_error``."""
    _, pt = pair(grid_trace(0, 20))
    psys = port_sys(JN)
    study = ptech.RowHammerMitigationStudy(
        psys, fault_model=PFault(seed=1, hammer_threshold=8))
    with pytest.raises(ValueError, match="on_error"):
        study.evaluate(n_requests=20, device=CPU, on_error="ignore")
    assert "flips" in pe.run(
        pt, psys.with_faults(PFault(seed=1, hammer_threshold=8)),
        device=CPU)
    with pytest.raises(ValueError, match="banks"):
        bad = interop.trace_from_arrays([0], [16], [0], [1])
        pe.run(bad, psys, device=CPU)
