"""The port's trace-file loaders, stream generators and Campaign stream
points against the JAX package in one process: ``parse_trace_line``,
``load_trace_file`` and ``iter_trace_file_windows`` (plain and ``.gz``,
with and without an ``LLC``) yield the reference's requests and raise its
errors, ``synthetic_stream`` its windows, and a Campaign that mixes stream
and batched points its records (the plain engine, ``device="cpu"``).
"""
import dataclasses
import gzip

import numpy as np
import pytest
import torch

from repro.core import cachesim as jcache, traces as jtr
from repro.core.campaign import Campaign as JCampaign
from repro.core.timescale import JETSON_NANO as JN

from repro_torch import interop
from repro_torch.core import cachesim as pcache, emulator as pe
from repro_torch.core import traces as ptr
from repro_torch.core.campaign import Campaign as PCampaign

torch.set_num_threads(1)
GEO_J = JN.geometry
FIELDS = ("kind", "bank", "row", "delta", "dep")
AGG = ("exec_cycles", "row_hits", "served", "dram_ticks", "smc_fpga_cycles")
LINES = ["0x1A40 R", "256 W", "W 0x2000", "4096", "", "# a comment",
         "// another", "1000,ReadReq,0x2000", "2000, WriteReq, 8192, 64",
         "3000,rd,0x100", "ld 77", "0x10 st", "  0XfF   readex  ",
         "5 writeback", "  ", "12 p # trailing comment"]
BAD = ["what even is this", "zzz W", "1, 2", "R W", "1 2 3", "1,foo,2",
       "0x R"]


def port_sys(jsys):
    return interop.system_config_from_dict(dataclasses.asdict(jsys))


def port_geo():
    return port_sys(JN).geometry


def assert_traces_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:   # the error itself is compared
        return (type(e), str(e))


@pytest.mark.parametrize("line", LINES + BAD)
def test_parse_trace_line_equals_reference(line):
    assert outcome(lambda: ptr.parse_trace_line(line, "f.trace", 7)) == \
        outcome(lambda: jtr.parse_trace_line(line, "f.trace", 7))


def write_trace(path, n, gz=False, seed=0):
    """A ramulator-style text trace of n requests, mixed layouts."""
    rng = np.random.RandomState(seed)
    addrs = rng.randint(0, 1 << 24, n) * 64
    lines = []
    for i, a in enumerate(addrs):
        op = "W" if rng.randint(3) == 0 else "R"
        if i % 5 == 0:
            lines.append(f"{i * 10}, {'WriteReq' if op == 'W' else 'ReadReq'}"
                         f", {hex(a)}, 64")
        elif i % 7 == 0:
            lines.append(f"{op} {a}")
        else:
            lines.append(f"{hex(a)} {op}")
        if i % 50 == 0:
            lines.append("# marker")
    text = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("llc", [False, True])
def test_trace_file_loaders_equal_reference(tmp_path, gz, llc):
    path = write_trace(tmp_path / ("t.trace.gz" if gz else "t.trace"), 1500,
                       gz=gz, seed=int(gz) + 2 * int(llc))
    jllc = (lambda: jcache.LLC(size_bytes=32 * 1024)) if llc else (
        lambda: None)
    pllc = (lambda: pcache.LLC(size_bytes=32 * 1024)) if llc else (
        lambda: None)
    assert list(ptr.iter_trace_requests(path, 100)) == \
        list(jtr.iter_trace_requests(path, 100))
    whole = ptr.load_trace_file(path, port_geo(), delta=3, window_dep=1,
                                llc=pllc())
    assert_traces_equal(whole, jtr.load_trace_file(
        path, GEO_J, delta=3, window_dep=1, llc=jllc()))
    got = list(ptr.iter_trace_file_windows(path, port_geo(), window=128,
                                           llc=pllc()))
    want = list(jtr.iter_trace_file_windows(path, GEO_J, window=128,
                                            llc=jllc()))
    assert [t.n for t in got] == [t.n for t in want]
    for a, b in zip(got, want):
        assert_traces_equal(a, b)
    # the windows concatenate to the whole file (the LLC carries across)
    cat = ptr.load_trace_file(path, port_geo(), llc=pllc())
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(cat, f), np.concatenate([getattr(w, f) for w in got]))
    few = ptr.load_trace_file(path, port_geo(), max_requests=10)
    assert few.n == jtr.load_trace_file(path, GEO_J, max_requests=10).n == 10


def test_trace_file_errors_name_the_line(tmp_path):
    p = tmp_path / "bad.trace"
    p.write_text("0x10 R\nwhat even is this\n")
    q = tmp_path / "bad2.trace.gz"
    with gzip.open(q, "wt") as fh:
        fh.write("0x10 R\n\n# c\nzzz W\n")
    for path in (str(p), str(q)):
        want = outcome(lambda: jtr.load_trace_file(path, GEO_J))
        got = outcome(lambda: ptr.load_trace_file(path, port_geo()))
        assert got == want and got[0] is ValueError
        assert outcome(lambda: list(ptr.iter_trace_file_windows(
            path, port_geo(), window=1))) == outcome(
            lambda: list(jtr.iter_trace_file_windows(path, GEO_J, window=1)))
    assert outcome(lambda: next(ptr.iter_trace_file_windows(
        str(p), port_geo(), window=0))) == outcome(
        lambda: next(jtr.iter_trace_file_windows(str(p), GEO_J, window=0)))
    empty = tmp_path / "empty.trace"
    empty.write_text("# nothing\n\n")
    assert ptr.load_trace_file(str(empty), port_geo()).n == 0


@pytest.mark.parametrize("n,window,seed", [(5000, 777, 3), (100, 4096, 0),
                                           (4096, 1024, 2 ** 30)])
def test_synthetic_stream_equals_reference(n, window, seed):
    got = list(ptr.synthetic_stream(n, window=window, seed=seed, n_banks=8,
                                    n_rows=512, kinds=3, delta_max=5,
                                    dep_max=4))
    want = list(jtr.synthetic_stream(n, window=window, seed=seed, n_banks=8,
                                     n_rows=512, kinds=3, delta_max=5,
                                     dep_max=4))
    assert sum(t.n for t in got) == n
    assert [t.n for t in got] == [t.n for t in want]
    for a, b in zip(got, want):
        assert_traces_equal(a, b)


def test_trace_file_stream_equals_whole_file_run(tmp_path):
    """A gzip trace through an LLC, streamed window by window, equals the
    whole file's single-shot run."""
    path = write_trace(tmp_path / "s.trace.gz", 400, gz=True, seed=5)
    psys = port_sys(JN)
    whole = ptr.load_trace_file(path, port_geo(),
                                llc=pcache.LLC(size_bytes=16 * 1024))
    a = pe.run(whole, psys, "ts", device="cpu")
    s = pe.run_stream(
        lambda: ptr.iter_trace_file_windows(
            path, port_geo(), window=96,
            llc=pcache.LLC(size_bytes=16 * 1024)),
        psys, "ts", chunk=64, device="cpu")
    for k in AGG:
        assert int(a[k]) == int(s[k]), k
    np.testing.assert_array_equal(a["t_resp"][:whole.n], s["t_resp"])
    np.testing.assert_array_equal(a["t_issue"][:whole.n], s["t_issue"])


def campaign_points(C, traces_mod, tr):
    c = C()
    c.add(tr, JN_OF[C], mode="ts", arm="batch")
    c.add(lambda: traces_mod.iter_windows(tr, 64), JN_OF[C], mode="ts",
          stream=True, chunk=32, arm="stream")
    c.add(lambda: traces_mod.synthetic_stream(500, window=128, seed=1),
          JN_OF[C], mode="nots", stream=True, chunk=32, arm="synth")
    c.add(tr, JN_OF[C], mode="reference", arm="batch-ref")
    return c


JN_OF = {JCampaign: JN, PCampaign: port_sys(JN)}


def test_campaign_stream_points_mixed_with_batched():
    """tests/test_streaming.py::test_campaign_stream_axis_mixed_with_
    batched, on both packages: records, group counts and errors."""
    from repro.core.emulator import Trace as JTrace
    rng = np.random.RandomState(29)
    arrays = (rng.randint(0, 2, 200), rng.randint(0, 16, 200),
              rng.randint(0, 4096, 200), rng.randint(0, 24, 200),
              rng.randint(0, 3, 200))
    jt, pt = JTrace.of(*arrays), pe.Trace.of(*arrays)
    jc = campaign_points(JCampaign, jtr, jt)
    pc = campaign_points(PCampaign, ptr, pt)
    assert pc.n_groups() == jc.n_groups() == 3
    for collect in ("aggregate", "full"):
        want = jc.run(serial=True, stream_collect=collect)
        got = pc.run(device="cpu", stream_collect=collect)
        assert [r["arm"] for r in got] == ["batch", "stream", "synth",
                                           "batch-ref"]
        for w, g in zip(want, got):
            assert set(w) == set(g), (sorted(w), sorted(g))
            for k in AGG:
                assert int(w[k]) == int(g[k]), (g["arm"], k)
            assert w["avg_load_latency_cycles"] == \
                g["avg_load_latency_cycles"]
            assert w["n_requests"] == g["n_requests"]
            assert w["mode"] == g["mode"]
            for k in ("t_resp", "t_issue"):
                if k in w:
                    np.testing.assert_array_equal(np.asarray(w[k]),
                                                  np.asarray(g[k]))
        assert "t_resp" in got[1] if collect == "full" \
            else "t_resp" not in got[1]
    for args, kw in (([[pt], JN_OF[PCampaign]], {}),
                     ([pt, JN_OF[PCampaign]], {"chunk": 64})):
        jargs = [[jt] if isinstance(args[0], list) else jt, JN]
        assert outcome(lambda: pc.add(*args, **kw)) == \
            outcome(lambda: jc.add(*jargs, **kw))
