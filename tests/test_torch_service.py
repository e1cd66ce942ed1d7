"""The port's sweep service (``repro_torch.service``) and the engine's plan
cache on the CPU (``device="cpu"``: the plain engine), as
``tests/test_service.py`` probes the reference's.

Against JAX: two clients' records over a cut grid (``ts``, ``nots`` and a
runtime policy point, three groups) equal JAX's ``Campaign.run(serial=True)``
on every field, and the plan cache's counters equal JAX's ``cache_stats()``
over one fixed sequence of calls (capacity 128, then 1). Against the port's
own serial ``Campaign.run``: a three-client grid mixing modes, a fault
model, a Bloom filter, staged and runtime policies; coalescing across
clients; collect order; checkpoint drain, abort, ``load_pending`` and
resume. Then the typed errors (locally and over the socket), the stride
order, exit without ``close()``, the cache's snapshots under threads, the
executor's environment defaults, the launcher's ``sweep`` subcommand and
the package's imports.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core import emulator as je, smcprog as jsmc
from repro.core.campaign import Campaign as JCampaign
from repro.core.timescale import JETSON_NANO as JN

from repro_torch import interop
from repro_torch.core import emulator as pe, executor, smcprog as psmc
from repro_torch.core.campaign import Campaign as PCampaign, Point
from repro_torch.core.faults import FaultModel
from repro_torch.kernels import ops
from repro_torch.launch import serve as plaunch
from repro_torch.service import (QueueFullError, ServerClosedError,
                                 SweepClient, SweepServer, load_pending)
from repro_torch.service import __main__ as service_main

from test_torch_engine import grid_trace, trace_bloom

torch.set_num_threads(1)
CPU = "cpu"
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
PSYS = interop.system_config_from_dict(dataclasses.asdict(JN))
SYS_FAULTS = PSYS.with_faults(
    FaultModel(seed=3, hammer_threshold=8, hammer_flip_fp=30000,
               weak_fp=16000, retention_ticks=30, victim_slots=16))
SYS_POLICY = PSYS.with_policy(psmc.frfcfs_program())


def server(**kw):
    return SweepServer(device=CPU, **kw)


def ptrace(seed, n, **kw):
    return interop.trace_from_arrays(**grid_trace(seed, n, **kw))


def assert_records_equal(want, got, label=""):
    assert set(want) == set(got), (label, set(want) ^ set(got))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            np.testing.assert_array_equal(np.asarray(w), np.asarray(g),
                                          err_msg=f"{label} {k}")
        else:
            assert w == g, (label, k, w, g)


def serial_reference(pts):
    c = PCampaign()
    c.points = list(pts)
    return c.run(serial=True, device=CPU)


def collect_by_idx(clients):
    got = {}
    for cli in clients:
        for r in cli.collect(timeout=120):
            got[r["idx"]] = r
    return got


# ---- against JAX: the plan cache's counters and a cut grid ----

def _jax_port_sequence(eng, trace, sys_, camp, **kw):
    """One fixed sequence of calls into ``eng`` (JAX's engine or the
    port's), with a snapshot of its cache counters after each stage: a
    cleared cache at capacity 128, three calls (ts twice, nots), the cut
    grid's Campaign (its ts and nots groups hit, its runtime-policy group
    misses), then capacity 1 (two evictions) and two more calls. Each
    miss compiles in JAX: four in all."""
    keys = ("hits", "misses", "evictions", "size")
    snaps = []
    eng.cache_clear()
    old = eng.set_cache_capacity(128)
    try:
        eng.run(trace, sys_, "ts", **kw)
        eng.run(trace, sys_, "ts", **kw)
        eng.run(trace, sys_, "nots", **kw)
        snaps.append({k: eng.cache_stats()[k] for k in keys})
        records = camp.run(serial=True, **kw)
        snaps.append({k: eng.cache_stats()[k] for k in keys})
        eng.set_cache_capacity(1)
        eng.run(trace, sys_, "ts", **kw)
        eng.run(trace, sys_, "ts", **kw)
        snaps.append({k: eng.cache_stats()[k] for k in keys})
    finally:
        eng.set_cache_capacity(old)
    return snaps, records


def _cut_grid(camp_cls, trace, sys_, prog):
    c = camp_cls()
    c.add(trace, sys_, mode="ts", idx=0)
    c.add(trace, sys_, mode="nots", idx=1)
    c.add_policy_grid(trace, sys_, [prog], idx=2)
    return c


@pytest.fixture(scope="module")
def jax_and_port():
    arrs = grid_trace(7, 30)
    jt, pt = je.Trace.of(**arrs), interop.trace_from_arrays(**arrs)
    jprog = jsmc.fcfs_program()
    pprog = interop.policy_from_fields(**dataclasses.asdict(jprog))
    jcamp = _cut_grid(JCampaign, jt, JN, jprog)
    pcamp = _cut_grid(PCampaign, pt, PSYS, pprog)
    assert jcamp.n_groups() == pcamp.n_groups() == 3
    jsnaps, jrecs = _jax_port_sequence(je, jt, JN, jcamp)
    psnaps, precs = _jax_port_sequence(pe, pt, PSYS, pcamp, device=CPU)
    return {"jax": (jsnaps, jrecs), "port": (psnaps, precs),
            "points": pcamp.points}


def test_plan_cache_counters_match_jax(jax_and_port):
    jsnaps, jrecs = jax_and_port["jax"]
    psnaps, precs = jax_and_port["port"]
    assert psnaps == jsnaps
    assert jsnaps == [{"hits": 1, "misses": 2, "evictions": 0, "size": 2},
                      {"hits": 3, "misses": 3, "evictions": 0, "size": 3},
                      {"hits": 4, "misses": 4, "evictions": 3, "size": 1}]
    for w, g in zip(jrecs, precs):
        assert_records_equal(w, g, f"campaign {g['idx']}")


def test_two_clients_match_jax_campaign(jax_and_port):
    _, jrecs = jax_and_port["jax"]
    pts = jax_and_port["points"]
    with server(coalesce_window_s=0.05) as srv:
        clis = [SweepClient(server=srv, name=f"c{k}") for k in range(2)]
        for j, p in enumerate(pts):
            clis[j % 2].submit_points([p])
        got = collect_by_idx(clis)
        st = srv.stats()
    assert st["dispatches"]["count"] == 3 and st["rejected"] == 0
    assert st["dispatches"]["policy_points"] == 1
    for w in jrecs:
        assert_records_equal(w, got[w["idx"]], f"service {w['idx']}")


# ---- against the port's serial Campaign.run ----

def mixed_points(n_base=4, seed=11):
    """A grid of every group-key dimension the coalescer must keep apart:
    ts / nots, a fault model, a Bloom filter, a staged and a runtime
    policy (bucket-32 traces, six groups)."""
    arrs = [grid_trace(seed + i, 24 + 2 * i, kinds=2) for i in range(4)]
    trs = [interop.trace_from_arrays(**a) for a in arrs[:n_base]]
    bloom = trace_bloom(arrs)
    prog = psmc.fcfs_program()
    pts = []
    for i, tr in enumerate(trs):
        pts.append(Point(tr, PSYS, "ts", None, {"idx": len(pts)}))
        pts.append(Point(tr, PSYS, "nots", None, {"idx": len(pts)}))
        if i % 2 == 0:
            pts.append(Point(tr, SYS_FAULTS, "ts", None, {"idx": len(pts)}))
            pts.append(Point(tr, PSYS, "reference", bloom,
                             {"idx": len(pts)}))
        else:
            pts.append(Point(tr, SYS_POLICY, "ts", None, {"idx": len(pts)}))
            pts.append(Point(tr, PSYS, "ts", None, {"idx": len(pts),
                                                    "policy": prog.name},
                             policy=prog, policy_cost=prog.smc_cycles()))
    return pts


@pytest.fixture(scope="module")
def mixed():
    pts = mixed_points()
    assert len({p.group_key() for p in pts}) == 6
    return pts, serial_reference(pts)


@pytest.fixture(scope="module")
def three_clients(mixed):
    """Three clients (weights 1, 1, 2) submit the grid interleaved from
    their own threads and collect."""
    pts, _ = mixed
    got, order, errs = {}, {}, []
    with server(coalesce_window_s=0.05) as srv:
        def client(k):
            try:
                cli = SweepClient(server=srv, name=f"c{k}",
                                  weight=2.0 if k == 2 else 1.0)
                mine = [p for j, p in enumerate(pts) if j % 3 == k]
                for p in mine:
                    cli.submit_points([p])
                recs = cli.collect(timeout=120)
                order[k] = ([p.meta["idx"] for p in mine],
                            [r["idx"] for r in recs])
                got.update((r["idx"], r) for r in recs)
            except Exception as e:   # surfaces below, on the test thread
                errs.append(e)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        stats = srv.stats()
    assert not errs, errs
    return got, order, stats


def test_three_clients_mixed_grid_matches_serial_campaign(mixed,
                                                          three_clients):
    pts, ref = mixed
    got, _, st = three_clients
    assert len(got) == len(ref)
    for i, r in enumerate(ref):
        assert_records_equal(r, got[i], f"point {i}")
    assert st["dispatches"]["points"] == len(pts)
    assert st["rejected"] == 0
    assert st["clients"]["c2"]["weight"] == 2.0
    assert all(c["completed"] == c["submitted"]
               for c in st["clients"].values())


def test_collect_preserves_submission_order(three_clients):
    _, order, _ = three_clients
    for submitted, collected in order.values():
        assert collected == submitted


def test_coalesces_across_clients():
    tr = ptrace(20, 60)
    with server(coalesce_window_s=0.25) as srv:
        clis = [SweepClient(server=srv, name=f"c{k}") for k in range(3)]
        for k, cli in enumerate(clis):
            cli.submit_points([Point(tr, PSYS, "ts", None, {"k": k, "j": j})
                               for j in range(4)])
        recs = [cli.collect(timeout=120) for cli in clis]
        st = srv.stats()
    assert st["dispatches"]["count"] == 1
    assert st["coalesce_ratio"] == 3.0
    assert st["points_per_dispatch"] == 12.0
    base = pe.run(tr, PSYS, device=CPU)
    for k, rs in enumerate(recs):
        assert [(r["k"], r["j"]) for r in rs] == [(k, j) for j in range(4)]
        for r in rs:
            assert_records_equal(base, {f: v for f, v in r.items()
                                        if f not in ("k", "j")})


def _counting_scans(monkeypatch):
    calls = []
    orig = ops.slot_scan

    def counted(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(ops, "slot_scan", counted)
    return calls


def test_drain_close_checkpoints_load_in_a_server_and_a_campaign(
        mixed, tmp_path, monkeypatch):
    pts, ref = mixed
    sub = pts[:6]
    d = str(tmp_path)
    with server(checkpoint=d, coalesce_window_s=0.02) as srv:
        cli = SweepClient(server=srv, name="a")
        cli.submit_points(sub)
        first = cli.collect(timeout=120)
    files = [f for f in os.listdir(d) if f.startswith("group-")]
    assert len(files) == len({p.group_key() for p in sub})
    calls = _counting_scans(monkeypatch)
    # a new server serves the same points from disk: nothing launched
    with server(checkpoint=d, coalesce_window_s=0.02) as srv:
        cli = SweepClient(server=srv, name="b")
        cli.submit_points(sub)
        again = cli.collect(timeout=120)
        st = srv.stats()
    assert st["dispatches"]["loaded_from_checkpoint"] \
        == st["dispatches"]["count"] == len(files)
    # and the port's Campaign resumes from the service's checkpoints
    c = PCampaign()
    c.points = list(sub)
    resumed = c.run(checkpoint=d, device=CPU)
    assert calls == []
    assert c.last_run["loaded"] == c.last_run["groups"] == len(files)
    for r, a, b, e in zip(ref, first, again, resumed):
        assert_records_equal(r, a)
        assert_records_equal(r, b)
        assert_records_equal(r, e)


def test_abort_close_pends_unfinished_and_resumes(mixed, tmp_path):
    """close(drain=False) fails queued points with a typed error naming
    the manifest's directory; the port's Campaign.run(checkpoint=dir)
    then finishes the sweep, loading the finished groups."""
    pts, ref = mixed
    d = str(tmp_path)
    # group keys apart: the fault, Bloom, staged and runtime-policy points
    # finish; the ts and nots points are queued when the server aborts
    half = [pts[2], pts[3], pts[6], pts[7]]
    rest = [pts[0], pts[1], pts[4], pts[5]]
    with server(checkpoint=d, coalesce_window_s=0.02) as srv:
        cli = SweepClient(server=srv, name="a")
        cli.submit_points(half)
        cli.collect(timeout=120)
    srv = server(checkpoint=d, coalesce_window_s=30.0, max_batch=512)
    cli = SweepClient(server=srv, name="a")
    cli.submit_points(rest)
    srv.close(drain=False)
    with pytest.raises(ServerClosedError) as ei:
        cli.collect(timeout=120)
    assert ei.value.checkpoint == d
    assert srv.stats()["dispatches"]["count"] == 0
    pend = load_pending(d)
    assert [p.meta["idx"] for p in pend] == [p.meta["idx"] for p in rest]
    c = PCampaign()
    c.points = half + pend
    resumed = c.run(checkpoint=d, device=CPU)
    assert (c.last_run["loaded"], c.last_run["computed"]) == (4, 2)
    for r in resumed:
        assert_records_equal(ref[r["idx"]], r, f"point {r['idx']}")


# ---- typed errors, the socket, fairness ----

def test_per_client_bound_is_typed_and_atomic():
    trs = [ptrace(30, 48)] * 4
    with server(max_pending=2, coalesce_window_s=30.0, max_batch=512) as srv:
        cli = SweepClient(server=srv, name="hog")
        with pytest.raises(QueueFullError) as ei:
            cli.submit_points([Point(t, PSYS, "ts") for t in trs])
        assert ei.value.scope == "per-client"
        assert ei.value.bound == 2 and ei.value.requested == 4
        # all or nothing: nothing of the refused batch is queued
        assert srv.stats()["clients"]["hog"]["queue_depth"] == 0
        assert srv.stats()["clients"]["hog"]["rejected"] == 4
        cli.submit_points([Point(t, PSYS, "ts") for t in trs[:2]])
        srv.close(drain=True)
        assert len(cli.collect(timeout=120)) == 2


def test_global_bound_names_the_global_scope():
    tr = ptrace(31, 48)
    with server(max_pending=8, max_queue=2, max_batch=512,
                coalesce_window_s=30.0) as srv:
        a = SweepClient(server=srv, name="a")
        b = SweepClient(server=srv, name="b")
        a.submit_points([Point(tr, PSYS, "ts"), Point(tr, PSYS, "ts")])
        with pytest.raises(QueueFullError) as ei:
            b.submit(tr, PSYS)
        assert ei.value.scope == "global" and ei.value.outstanding == 2
        srv.close(drain=True)
        assert len(a.collect(timeout=120)) == 2


def test_closed_server_stream_points_and_meta_clash():
    tr = ptrace(32, 40)
    srv = server()
    cli = SweepClient(server=srv, name="late")
    with pytest.raises(ValueError, match="stream"):
        cli.submit_points([Point(tr, PSYS, "ts", stream=True)])
    with pytest.raises(ValueError, match="stream"):
        srv.submit("late", iter([tr]), PSYS)
    cli.submit(tr, PSYS, exec_cycles=1)   # a meta key shadowing a field
    with pytest.raises(ValueError, match="shadow"):
        cli.collect(timeout=120)
    srv.close()
    with pytest.raises(ServerClosedError):
        cli.submit(tr, PSYS)
    with pytest.raises(ServerClosedError):
        SweepClient(server=srv, name="later")
    e = pickle.loads(pickle.dumps(ServerClosedError("closed", "ckpt-dir")))
    assert type(e) is ServerClosedError and e.checkpoint == "ckpt-dir"


def test_socket_roundtrip_stats_and_typed_errors(mixed):
    pts, ref = mixed
    sub = pts[:4]
    with server(coalesce_window_s=0.02, max_pending=64) as srv:
        host, port = srv.listen()
        with SweepClient(address=(host, port), name="far") as cli:
            assert cli.name == "far"
            cli.submit_points(sub)
            for a, b in zip(cli.collect(timeout=120), ref):
                assert_records_equal(b, a)
            st = cli.stats()
            assert st["clients"]["far"]["completed"] == len(sub)
            assert st["device"] == "cpu"
    # typed backpressure crosses the wire with its fields
    with server(max_pending=1, coalesce_window_s=30.0) as tiny:
        with SweepClient(address=tiny.listen(), name="far2") as cli:
            with pytest.raises(QueueFullError) as ei:
                cli.submit_points([Point(sub[0].trace, PSYS, "ts"),
                                   Point(sub[1].trace, PSYS, "ts")])
            assert (ei.value.scope, ei.value.bound, ei.value.requested,
                    ei.value.client) == ("per-client", 1, 2, "far2")


def test_stride_order_gives_weighted_share():
    """A at weight 1 and B at weight 2 queued together: the stride drain
    interleaves them 1:2 (first six A, B, B, A, B, B)."""
    tr = ptrace(33, 64)
    srv = server(coalesce_window_s=30.0, max_batch=512)
    try:
        a = SweepClient(server=srv, name="a", weight=1.0)
        b = SweepClient(server=srv, name="b", weight=2.0)
        # the server's condition holds an RLock: holding it keeps the
        # dispatcher from draining until both batches are queued
        with srv._cond:
            a.submit_points([Point(tr, PSYS, "ts", None, {"c": "a", "j": j})
                             for j in range(4)])
            b.submit_points([Point(tr, PSYS, "ts", None, {"c": "b", "j": j})
                             for j in range(4)])
        deadline = time.monotonic() + 30
        jobs = []
        while time.monotonic() < deadline:
            with srv._cond:
                jobs = [j for bk in srv._buckets.values() for j in bk.jobs]
            if len(jobs) == 8:
                break
            time.sleep(0.01)
        assert [j.client for j in jobs][:6] == ["a", "b", "b", "a", "b", "b"]
        srv.close(drain=True)
        assert len(a.collect(timeout=120)) == 4
        assert len(b.collect(timeout=120)) == 4
    finally:
        srv.close(drain=False)


# ---- shutdown, the cache under threads, small checks ----

def _python(code, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def exit_without_close():
    """A fresh interpreter that imports only ``repro_torch`` and never
    closes its servers, one with a point queued behind an hour's window;
    it lists any JAX or reference module it holds before it exits."""
    code = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.core.emulator import Trace
from repro_torch.core.timescale import JETSON_NANO
from repro_torch.service import SweepServer, SweepClient
rng = np.random.RandomState(0)
def mk():
    return Trace.of(kind=rng.randint(0, 2, 40), bank=rng.randint(0, 16, 40),
                    row=rng.randint(0, 4096, 40), delta=rng.randint(1, 8, 40),
                    dep=rng.randint(0, 2, 40))
srv = SweepServer(coalesce_window_s=0.01, device="cpu")
cli = SweepClient(server=srv, name="x")
cli.submit(mk(), JETSON_NANO)
assert cli.collect()[0]["exec_cycles"] > 0
srv2 = SweepServer(coalesce_window_s=3600.0, device="cpu")
cli2 = SweepClient(server=srv2, name="y")
cli2.submit(mk(), JETSON_NANO)
import repro_torch.service.__main__
print("FOREIGN", [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "repro" or m.startswith("repro.")])
print("EXITING")
"""
    return _python(code, timeout=120)


def test_interpreter_exit_without_close_does_not_hang(exit_without_close):
    """The service's atexit hook closes live servers before the executor's
    pool is poisoned, so the process exits cleanly."""
    proc = exit_without_close
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "EXITING" in proc.stdout


def test_service_imports_neither_jax_nor_reference(exit_without_close):
    assert "FOREIGN []" in exit_without_close.stdout, \
        exit_without_close.stdout


def test_cache_stats_consistent_under_threads():
    """Snapshots stay consistent (lookups == hits + misses, size <=
    capacity, size == misses - evictions) while threads plan groups of
    many keys through a two-entry cache."""
    trs = [ptrace(40 + i, n) for i, n in enumerate((20, 40, 70, 140))]
    stop = threading.Event()
    errs = []

    def reader():
        while not stop.is_set():
            s = pe.cache_stats()
            if not (s["lookups"] == s["hits"] + s["misses"]
                    and s["size"] <= s["capacity"]
                    and s["size"] == s["misses"] - s["evictions"]):
                errs.append(s)
                stop.set()

    def worker(k):
        for i in range(200):
            tr = trs[(i + k) % len(trs)]
            pe.prepare_tasks([tr] * (1 + k), PSYS, ["ts", "nots"][i % 2],
                             None, [None] * (1 + k), device=CPU)

    old_cap = pe.set_cache_capacity(2)
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pe.cache_clear()
        readers = [threading.Thread(target=reader) for _ in range(2)]
        workers = [threading.Thread(target=worker, args=(k,))
                   for k in range(6)]
        for t in readers + workers:
            t.start()
        for t in workers:
            t.join(60)
        stop.set()
        for t in readers:
            t.join(30)
        assert not any(t.is_alive() for t in readers + workers)
        s = pe.cache_stats()
    finally:
        sys.setswitchinterval(old_switch)
        pe.set_cache_capacity(old_cap)
    assert not errs, errs[0]
    assert s["lookups"] == 6 * 200 and s["evictions"] > 0
    assert s["persistent"] == {"hits": 0, "misses": 0, "dir": None}


class FakeTask:
    retryable = True
    device = None

    def __init__(self, label, fails=0, sleep=0.0):
        self.label, self.cost = label, 1
        self.fails, self.sleep, self.runs = fails, sleep, 0

    def run(self):
        self.runs += 1
        time.sleep(self.sleep)
        if self.runs <= self.fails:
            raise RuntimeError(f"boom {self.label} run{self.runs}")


def test_executor_environment_defaults(monkeypatch):
    """REPRO_EXEC_RETRIES / REPRO_EXEC_BACKOFF_S / REPRO_EXEC_TIMEOUT_S are
    the defaults of submit_task's and execute's keywords (the service's
    dispatches pass none)."""
    monkeypatch.setenv("REPRO_EXEC_RETRIES", "2")
    monkeypatch.setenv("REPRO_EXEC_BACKOFF_S", "0.001")
    flaky = FakeTask("flaky", fails=2)
    assert executor.submit_task(flaky).result(30) is None
    assert flaky.runs == 3
    dead = FakeTask("dead", fails=9)
    assert executor.submit_task(dead).result(30).attempts == 3
    monkeypatch.setenv("REPRO_EXEC_RETRIES", "0")
    monkeypatch.setenv("REPRO_EXEC_TIMEOUT_S", "0.3")
    slow, quick = FakeTask("slow", sleep=1.5), FakeTask("quick")
    old = executor.set_workers(max(2, executor.workers()))
    try:
        fails = executor.execute([slow, quick], serial=False,
                                 raise_on_error=False)
    finally:
        executor.set_workers(old)   # joins the abandoned sleeper
    assert [f.label for f in fails] == ["slow"]
    assert isinstance(fails[0].error, TimeoutError) and quick.runs == 1


def test_sweep_subcommand_defaults_to_cuda_and_runs_on_cpu(monkeypatch,
                                                           capsys):
    """``launch.serve sweep`` reaches the service's parser; without a card
    the default device raises, and ``--device cpu`` serves until Ctrl-C
    (here a sleep that raises it), then drains and returns."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plaunch.main(["sweep", "--port", "0"])
    with pytest.raises(ValueError, match="no kernel library"):
        SweepServer(device=CPU, persistent_cache=True)

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(service_main, "time",
                        types.SimpleNamespace(sleep=interrupt))
    plaunch.main(["sweep", "--port", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "listening on 127.0.0.1:" in out and "(cpu)" in out
    assert "draining" in out
