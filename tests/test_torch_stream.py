"""The port's streaming driver against the JAX package in one process:
``run_stream`` / ``run_stream_many`` on the plain engine
(``device="cpu"``) against the reference's, and against the port's own
single-shot ``run``, on the grid of ``tests/test_streaming.py``; the
window step itself against the reference's ``_stream_step_core``, window
by window, on a state handed over through ``interop``. Every int field,
every fault field, ``bit_error_rate`` and ``avg_load_latency_cycles``
must be equal, and every error's type and text.

The JAX side is computed once per module (``jax_side``): each distinct
(chunk, config, mode, batch, filter, table) compiles one window program,
about a second each.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import emulator as je, smcprog as jsmc, traces as jtr
from repro.core.bloom import BloomFilter
from repro.core.faults import FaultModel as JFault
from repro.core.timescale import JETSON_NANO as JN

from repro_torch import interop
from repro_torch.core import emulator as pe, traces as ptr
from repro_torch.core.state import StreamState
from repro_torch.kernels import ops

torch.set_num_threads(1)
CPU = "cpu"
AGG = ("exec_cycles", "row_hits", "served", "dram_ticks", "smc_fpga_cycles")
FAULT_FIELDS = ("flips", "ham_flips", "ret_flips", "mitigations",
                "victim_bank", "victim_row", "victim_t")
# tests/test_streaming.py::test_stream_bit_identical_to_run
GRID = [(5, 16, 4, "ts"), (31, 12, 1, "ts"), (33, 16, 2, "nots"),
        (100, 16, 4, "reference"), (257, 32, 8, "ts"), (640, 100, 4, "nots")]
FM = JFault(seed=3, hammer_threshold=8, hammer_flip_fp=30000,
            weak_fp=16000, retention_ticks=30, victim_slots=16)


def port_sys(jsys):
    return interop.system_config_from_dict(dataclasses.asdict(jsys))


def port_prog(p):
    return interop.policy_from_fields(**dataclasses.asdict(p))


def random_arrays(rng, n, kinds=5, dep_max=3):
    """tests/test_streaming.py's random_trace, as arrays."""
    return (rng.randint(0, kinds, n), rng.randint(0, 16, n),
            rng.randint(0, 4096, n), rng.randint(0, 24, n),
            rng.randint(0, dep_max + 1, n))


def pair(arrays):
    return je.Trace.of(*arrays), pe.Trace.of(*arrays)


def grid_pair(n, chunk):
    return pair(random_arrays(np.random.RandomState(n * 7 + chunk), n))


def nop_run_pair():
    kind, bank, row, delta, dep = random_arrays(np.random.RandomState(11),
                                                120)
    kind[20:80] = 4
    delta[20:80] = 5   # NOPs carry compute time
    return pair((kind, bank, row, delta, dep))


def blooms():
    rng = np.random.RandomState(13)

    def mk(n_keys):
        bf = BloomFilter.build(
            rng.randint(0, 1 << 19, n_keys).astype(np.uint32),
            m_bits=1 << 14, k=3)
        return (bf.bits, bf.k, bf.m_bits)
    return mk(100), mk(50), rng


def assert_stream_equal(want, got, label="", n=None):
    for k in AGG:
        assert int(want[k]) == int(got[k]), f"{label} {k}"
    assert want["avg_load_latency_cycles"] == got["avg_load_latency_cycles"]
    assert want["exec_seconds"] == got["exec_seconds"], label
    if "t_resp" in got:
        for k in ("t_resp", "t_issue"):
            w = np.asarray(want[k])
            np.testing.assert_array_equal(w if n is None else w[:n],
                                          np.asarray(got[k]),
                                          err_msg=f"{label} {k}")
    if "flips" in want:
        for k in FAULT_FIELDS:
            np.testing.assert_array_equal(np.asarray(want[k]),
                                          np.asarray(got[k]),
                                          err_msg=f"{label} {k}")
        assert float(want["bit_error_rate"]) == float(got["bit_error_rate"])


def stream_policies():
    return [jsmc.frfcfs_program(), jsmc.fcfs_program()]


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result the module compares against, computed once."""
    out = {"grid": {}}
    for n, chunk, window, mode in GRID:
        jt, _ = grid_pair(n, chunk)
        sysc = dataclasses.replace(JN, window=window)
        out["grid"][n] = je.run_stream(jt, sysc, mode, chunk=chunk)
    jt, _ = nop_run_pair()
    out["nop_run"] = je.run_stream(jt, JN, "ts", chunk=16)
    rng = np.random.RandomState(5)
    trs = [pair(random_arrays(rng, n))[0] for n in (40, 300, 7)]
    out["mixed"] = je.run_stream_many(trs, JN, ["ts", "nots", "reference"],
                                      chunk=32)
    bl, bl2, rng = blooms()
    t0 = pair(random_arrays(rng, 90))[0]
    t1 = pair(random_arrays(rng, 40))[0]
    out["bloom_shared"] = je.run_stream(t0, JN, "ts", bloom=bl, chunk=16)
    out["bloom_stacked"] = je.run_stream_many([t0, t1], JN, "ts",
                                              blooms=[bl, bl2], chunk=16)
    jt = pair(random_arrays(np.random.RandomState(17), 80))[0]
    out["staged"] = je.run_stream(
        jt, dataclasses.replace(JN, policy=jsmc.frfcfs_program()), "ts",
        chunk=16)
    out["runtime"] = je.run_stream_many(
        [jt, jt], JN, "ts", chunk=16, policies=stream_policies(),
        policy_costs=[p.smc_cycles() for p in stream_policies()])
    hammer = jtr.rowhammer_trace(96, JN.geometry, intensity=0.75, seed=5)
    out["faults"] = je.run_stream(hammer, JN.with_faults(FM), "ts", chunk=32)
    return out


@pytest.mark.parametrize("n,chunk,window,mode", GRID)
def test_stream_equals_reference_and_single_shot(jax_side, n, chunk, window,
                                                 mode):
    _, pt = grid_pair(n, chunk)
    psys = port_sys(dataclasses.replace(JN, window=window))
    s = pe.run_stream(pt, psys, mode, chunk=chunk, device=CPU)
    assert int(s["served"]) == pt.n_real
    assert s["t_resp"].shape == (n,)
    assert_stream_equal(jax_side["grid"][n], s, "vs reference")
    assert_stream_equal(pe.run(pt, psys, mode, device=CPU), s, "vs run",
                        n=n)


def test_stream_mid_trace_nop_run_crossing_chunks(jax_side):
    """A 60-NOP run spanning several 16-request chunks: frozen slots and
    the empty-queue idle hop across window handoffs."""
    _, pt = nop_run_pair()
    s = pe.run_stream(pt, port_sys(JN), "ts", chunk=16, device=CPU)
    assert_stream_equal(jax_side["nop_run"], s)


def test_stream_many_mixed_modes(jax_side):
    rng = np.random.RandomState(5)
    pts = [pair(random_arrays(rng, n))[1] for n in (40, 300, 7)]
    ss = pe.run_stream_many(pts, port_sys(JN), ["ts", "nots", "reference"],
                            chunk=32, device=CPU)
    for i, (want, got) in enumerate(zip(jax_side["mixed"], ss)):
        assert got["mode"] == want["mode"]
        assert_stream_equal(want, got, f"stream {i}")


def test_stream_window_iterator_and_factory_inputs(jax_side):
    """Pre-sliced windows of odd sizes and a generator factory equal the
    whole trace (the port's iter_windows yields the reference's)."""
    jt, pt = nop_run_pair()
    for w in (7, 41):
        got = list(ptr.iter_windows(pt, w))
        want = list(jtr.iter_windows(jt, w))
        assert [t.n for t in got] == [t.n for t in want]
        for a, b in zip(got, want):
            for f in ("kind", "bank", "row", "delta", "dep"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    psys = port_sys(JN)
    b = pe.run_stream(ptr.iter_windows(pt, 7), psys, "ts", chunk=16,
                      device=CPU)
    c = pe.run_stream(lambda: ptr.iter_windows(pt, 41), psys, "ts",
                      chunk=16, device=CPU)
    assert_stream_equal(jax_side["nop_run"], b, "windows")
    assert_stream_equal(jax_side["nop_run"], c, "factory")
    with pytest.raises(ValueError, match="window must be >= 1"):
        next(ptr.iter_windows(pt, 0))


def test_stream_bloom_shared_and_stacked(jax_side):
    bl, bl2, rng = blooms()
    p0 = pair(random_arrays(rng, 90))[1]
    p1 = pair(random_arrays(rng, 40))[1]
    psys = port_sys(JN)
    s = pe.run_stream(p0, psys, "ts", bloom=bl, chunk=16, device=CPU)
    assert_stream_equal(jax_side["bloom_shared"], s, "shared")
    ss = pe.run_stream_many([p0, p1], psys, "ts", blooms=[bl, bl2],
                            chunk=16, device=CPU)
    for want, got in zip(jax_side["bloom_stacked"], ss):
        assert_stream_equal(want, got, "stacked")


def test_stream_policy_programs(jax_side):
    """A staged ``sys.policy`` and runtime tables, one per stream."""
    pt = pair(random_arrays(np.random.RandomState(17), 80))[1]
    psys = port_sys(JN)
    staged = dataclasses.replace(psys,
                                 policy=port_prog(jsmc.frfcfs_program()))
    s = pe.run_stream(pt, staged, "ts", chunk=16, device=CPU)
    assert_stream_equal(jax_side["staged"], s, "staged")
    progs = [port_prog(p) for p in stream_policies()]
    ss = pe.run_stream_many([pt, pt], psys, "ts", chunk=16, policies=progs,
                            policy_costs=[p.smc_cycles() for p in progs],
                            device=CPU)
    for want, got in zip(jax_side["runtime"], ss):
        assert_stream_equal(want, got, "runtime")


def test_stream_fault_model_matches_reference_and_single_shot(jax_side):
    """tests/test_faults.py::test_stream_matches_single_shot: the fault
    carry rides the window shift untouched."""
    hammer = jtr.rowhammer_trace(96, JN.geometry, intensity=0.75, seed=5)
    pt = interop.trace_from_arrays(hammer.kind, hammer.bank, hammer.row,
                                   hammer.delta, hammer.dep)
    psys = port_sys(JN.with_faults(FM))
    s = pe.run_stream(pt, psys, "ts", chunk=32, device=CPU)
    assert int(s["ham_flips"]) > 0 and int(s["ret_flips"]) > 0
    assert_stream_equal(jax_side["faults"], s, "vs reference")
    assert_stream_equal(pe.run(pt, psys, "ts", device=CPU), s, "vs run",
                        n=pt.n)


def test_stream_aggregate_matches_full(jax_side):
    _, pt = grid_pair(100, 16)
    psys = port_sys(JN)
    g = pe.run_stream(pt, psys, "reference", chunk=16, collect="aggregate",
                      device=CPU)
    assert "t_resp" not in g and "t_issue" not in g
    assert_stream_equal(jax_side["grid"][100], g)
    assert g["n_requests"] == pt.n_real


def test_stream_empty_and_all_nop_streams():
    psys = port_sys(JN)
    for jax_in, port_in in (
            (iter([]), iter([])),
            (je.Trace.of(np.full(50, 4), np.zeros(50), np.zeros(50),
                         np.ones(50)),
             pe.Trace.of(np.full(50, 4), np.zeros(50), np.zeros(50),
                         np.ones(50)))):
        want = je.run_stream(jax_in, JN, "ts", chunk=16,
                             collect="aggregate")
        got = pe.run_stream(port_in, psys, "ts", chunk=16,
                            collect="aggregate", device=CPU)
        assert int(got["served"]) == 0 and got["n_requests"] == 0
        assert_stream_equal(want, got)


def errors(fn):
    try:
        fn()
    except Exception as e:   # the error itself is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["chunk", "chunk_type", "collect", "dep",
                                  "dep_negative", "not_a_trace", "mode"])
def test_stream_errors_equal_reference(case):
    """Every argument and window error, with the reference's type and
    text."""
    z = (np.zeros(10),) * 4
    deep = z + (np.full(10, 20),)
    neg = z + (np.full(10, -1),)
    args = {"chunk": (z, dict(chunk=4)), "chunk_type": (z, dict(chunk=16.0)),
            "collect": (z, dict(chunk=16, collect="bogus")),
            "dep": (deep, dict(chunk=16)), "dep_negative": (neg, dict(
                chunk=16)),
            "not_a_trace": (None, dict(chunk=16)),
            "mode": (z, dict(chunk=16, mode="bogus"))}[case]
    arrays, kw = args
    kw = {"mode": "ts", **kw}
    if arrays is None:
        jin, pin = iter([np.zeros(4)]), iter([np.zeros(4)])
    else:
        jin, pin = pair(arrays)
    want = errors(lambda: je.run_stream(jin, JN, **kw))
    got = errors(lambda: pe.run_stream(pin, port_sys(JN), device=CPU, **kw))
    assert want is not None
    assert got == want


def test_stream_dep_max_admits_a_deep_dep():
    """A larger dep_max admits a deep dependence (the halo grows)."""
    z = (np.zeros(10),) * 4
    _, pt = pair(z + (np.full(10, 20),))
    psys = port_sys(JN)
    s = pe.run_stream(pt, psys, "ts", chunk=32, dep_max=20, device=CPU)
    assert_stream_equal(pe.run(pt, psys, "ts", device=CPU), s, n=10)


def test_window_step_equals_reference_step_on_a_handed_over_state():
    """The port's window (shift + ops.slot_scan_window) against the
    reference's ``_stream_step_core``, window by window, each from the
    reference's own state handed over through ``interop``: every
    EmulatorState field, the fault carry and the emitted arrays."""
    hammer = jtr.rowhammer_trace(150, JN.geometry, intensity=0.75, seed=9)
    sysj = JN.with_faults(FM)
    psys = port_sys(sysj)
    chunk = 32
    H = je.stream_halo(sysj)
    assert pe.stream_halo(psys) == H
    L = chunk + H
    slots = je.stream_slot_budget(chunk, sysj)
    assert pe.stream_slot_budget(chunk, psys) == slots

    step = jax.jit(lambda ss, a, b, c, d, e, final: je._stream_step_core(
        ss, a, b, c, d, e, final, sysj, "ts", None, 0, 1, chunk, slots))
    ss = je._stream_init(chunk, H, sysj)
    fields = [np.asarray(getattr(hammer, f), np.int32)
              for f in ("kind", "bank", "row", "delta", "dep")]
    n_win = -(-hammer.n // chunk)
    tables, costs, lb, para = pe._group_tables(psys, [0], None, None, 1,
                                               CPU)
    p = pe._scan_params(psys, "ts", 1, L, slots, lb, False, para)
    for k in range(n_win):
        blk = []
        for a in fields:
            b = a[k * chunk:(k + 1) * chunk]
            pad = np.full(chunk - b.size, 4 if a is fields[0] else 0,
                          np.int32)
            blk.append(np.concatenate([b, pad]))
        final = k == n_win - 1
        port = interop.stream_state_from_host(
            jax.tree_util.tree_map(lambda x: np.asarray(x)[None],
                                   ss.emu.to_host()),
            *(np.asarray(getattr(ss, f))[None]
              for f in ("kind", "bank", "row", "delta", "dep")))
        ss, out = step(ss, *blk, np.int32(final))
        shifted = pe.shift_window(port, {
            f: torch.from_numpy(b[None]) for f, b in zip(
                ("kind", "bank", "row", "delta", "dep"), blk)}, chunk)
        emu = ops.slot_scan_window(shifted.emu, shifted.kind, shifted.bank,
                                   shifted.row, shifted.delta, shifted.dep,
                                   None, tables, costs, p, final)
        got = StreamState(emu=emu, **{
            f: getattr(shifted, f)
            for f in ("kind", "bank", "row", "delta", "dep")}).to_host()
        want = jax.tree_util.tree_map(np.asarray, dataclasses.asdict(ss))
        for key, w in want["emu"].items():
            if isinstance(w, dict):
                for kk, ww in w.items():
                    np.testing.assert_array_equal(
                        got["emu"][key][kk][0], ww,
                        err_msg=f"window {k} {key}.{kk}")
            else:
                np.testing.assert_array_equal(got["emu"][key][0], w,
                                              err_msg=f"window {k} {key}")
        for f in ("kind", "bank", "row", "delta", "dep"):
            np.testing.assert_array_equal(got[f][0], want[f])
        np.testing.assert_array_equal(np.asarray(out[2]),
                                      got["emu"]["t_resp"][0])
    assert int(np.asarray(ss.emu.faults["vptr"])) > 0


def test_window_scan_params_do_not_depend_on_the_stream_length(
        monkeypatch):
    """The port's counterpart of the reference's length-free compile key:
    every window of a 40- and a 300-request stream launches with one
    ``ScanParams``, and a different chunk changes it."""
    seen = []
    orig = ops.slot_scan_window

    def spy(*args):
        seen.append(args[-2])
        return orig(*args)
    monkeypatch.setattr(ops, "slot_scan_window", spy)
    rng = np.random.RandomState(23)
    psys = port_sys(JN)
    for n in (40, 300):
        pe.run_stream(pair(random_arrays(rng, n))[1], psys, "ts", chunk=32,
                      collect="aggregate", device=CPU)
    assert len(seen) == 2 + 10 and len(set(seen)) == 1
    pe.run_stream(pair(random_arrays(rng, 40))[1], psys, "ts", chunk=64,
                  collect="aggregate", device=CPU)
    assert seen[-1] != seen[0]
    assert seen[0].n == 32 + pe.stream_halo(psys)
