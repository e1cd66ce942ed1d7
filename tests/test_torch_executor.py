"""The port's campaign executor (``repro_torch.core.executor``) and the
Campaign's run options on the CPU.

The executor's contract on fake tasks (as ``tests/test_executor.py``
probes the reference's): failure isolation, retries, stream tasks never
retried, timeout abandonment, shutdown and re-arm, the stream window
loop's order (assembled ahead, consumed one window behind) and its stop
and error paths. Then ``Campaign.run`` overlapped and serial
(``device="cpu"``: the plain engine) against the JAX ``Campaign.run`` on
a five-group grid with a Bloom point, a runtime policy point and a stream
point, exactly on every field; checkpoint resume (nothing recomputed,
files content-addressed), quarantine, and ``Point.content_digest``
against the reference's.
"""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import emulator as je, smcprog as jsmc, traces as jtr
from repro.core.campaign import Campaign as JCampaign, Point as JPoint
from repro.core.timescale import JETSON_NANO as JN

from repro_torch import interop
from repro_torch.core import campaign as pcampaign, emulator as pe
from repro_torch.core import executor, traces as ptr
from repro_torch.core.campaign import Campaign as PCampaign, Point as PPoint
from repro_torch.kernels import ops

from test_torch_engine import grid_trace, trace_bloom

torch.set_num_threads(1)
CPU = "cpu"
PSYS = interop.system_config_from_dict(dataclasses.asdict(JN))


class FakeTask:
    """Executor-contract probe: controllable failures, no engine."""
    retryable = True

    def __init__(self, label, fails=0, sleep=0.0):
        self.label, self.cost = label, 1
        self.fails, self.sleep, self.runs = fails, sleep, 0

    def run(self):
        self.runs += 1
        time.sleep(self.sleep)
        if self.runs <= self.fails:
            raise RuntimeError(f"boom {self.label} run{self.runs}")


@pytest.mark.parametrize("serial", [True, False])
def test_failures_are_isolated_and_every_label_is_named(serial):
    a, ok, b = FakeTask("a", fails=9), FakeTask("ok"), FakeTask("b", fails=9)
    with pytest.raises(executor.ExecutionError) as ei:
        executor.execute([a, ok, b], serial=serial)
    assert "2 task(s) failed" in str(ei.value)
    assert {f.label for f in ei.value.failures} == {"a", "b"}
    assert ok.runs == 1
    assert all(isinstance(f.error, RuntimeError) for f in ei.value.failures)
    fails = executor.execute([FakeTask("c", fails=9), FakeTask("fine")],
                             serial=serial, raise_on_error=False)
    assert [f.label for f in fails] == ["c"]


def test_retries_recover_a_transient_failure_and_stream_tasks_never_retry():
    flaky = FakeTask("flaky", fails=2)
    assert executor.execute([flaky], serial=True, retries=3,
                            backoff=0.001) == []
    assert flaky.runs == 3
    dead = FakeTask("dead", fails=99)
    fails = executor.execute([dead], serial=True, retries=2, backoff=0.001,
                             raise_on_error=False)
    assert fails[0].attempts == 3 and dead.runs == 3
    runs = []

    def pack():
        runs.append(1)
        raise RuntimeError("window loop failed")

    st = executor.StreamTask(fn=None, pack=pack, windows=None, consume=None,
                             finalize=None, label="stream")
    fails = executor.execute([st], serial=True, retries=5, backoff=0.001,
                             raise_on_error=False)
    assert not executor.StreamTask.retryable and executor.GroupTask.retryable
    assert len(runs) == 1 and fails[0].attempts == 1


def test_timeout_abandons_a_stuck_task():
    slow, quick = FakeTask("slow", sleep=1.5), FakeTask("quick")
    old = executor.set_workers(max(2, executor.workers()))
    try:
        t0 = time.monotonic()
        fails = executor.execute([slow, quick], serial=False, timeout=0.3,
                                 raise_on_error=False)
        dt = time.monotonic() - t0
    finally:
        executor.set_workers(old)   # joins the abandoned sleeper
    assert dt < 1.0
    assert [f.label for f in fails] == ["slow"]
    assert isinstance(fails[0].error, TimeoutError) and fails[0].attempts == 0
    assert quick.runs == 1


def test_shutdown_refuses_dispatches_until_rearmed():
    old = executor.workers()
    try:
        fut = executor.submit_task(FakeTask("async"))
        assert fut.result(timeout=10) is None
        fut = executor.submit_task(FakeTask("async-bad", fails=9))
        assert fut.result(timeout=10).label == "async-bad"
        executor.shutdown(wait=True)
        assert executor.is_shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            executor.submit_task(FakeTask("late"))
        with pytest.raises(RuntimeError, match="shut down"):
            executor.execute([FakeTask("x"), FakeTask("y")], serial=False)
    finally:
        executor.set_workers(old)
    assert not executor.is_shutdown()
    assert executor.execute([FakeTask("x"), FakeTask("y")],
                            serial=False) == []
    with pytest.raises(ValueError, match="worker count"):
        executor.set_workers(0)


def _window_task(n_windows=64, fn=None, windows=None, log=None):
    """A StreamTask over fake windows; ``log`` records, in order, each
    window's assembly, scan and consumption, and the generator's close."""
    seen = []
    log = [] if log is None else log

    def default_windows(ctx):
        try:
            for i in range(n_windows):
                log.append(("gen", i))
                yield (np.full(4, i),)
        finally:
            log.append("closed")

    def scan(state, a):
        log.append(("scan", int(a[0])))
        return state + 1, (a,)

    def consume(out, ctx):
        log.append(("consume", int(out[0][0])))
        seen.append(int(out[0][0]))

    task = executor.StreamTask(
        fn=fn or scan, pack=lambda: (0, None),
        windows=windows or default_windows, consume=consume,
        finalize=lambda state, ctx: seen.append(("final", state)),
        label="probe")
    return task, seen


def test_prefetch_delivers_every_window_in_order():
    task, seen = _window_task(n_windows=40)
    task.run()
    assert seen == list(range(40)) + [("final", 40)]


def test_prefetch_assembles_ahead_and_consumes_one_window_behind():
    """Window k+1 is assembled and its scan queued before window k's
    outputs are waited for and consumed."""
    log = []
    task, _ = _window_task(n_windows=3, log=log)
    task.run()
    assert log == [("gen", 0), ("scan", 0), ("gen", 1), ("scan", 1),
                   ("consume", 0), ("gen", 2), ("scan", 2), ("consume", 1),
                   "closed", ("consume", 2)]


def test_prefetch_stops_when_a_window_fails():
    """The scan raising on an early window of hundreds: no further window
    is assembled, and the generator is closed before the error leaves."""
    log = []

    def fn(state, a):
        if state == 2:
            raise RuntimeError("window exploded")
        return state + 1, (a,)

    task, seen = _window_task(n_windows=500, fn=fn, log=log)
    with pytest.raises(RuntimeError, match="window exploded"):
        task.run()
    assert log == [("gen", 0), ("gen", 1), ("consume", 0), ("gen", 2),
                   "closed"]
    assert seen == [0]


def test_prefetch_error_surfaces_on_the_consumer():
    def windows(ctx):
        yield (np.zeros(1),)
        raise ValueError("generator died")

    task, seen = _window_task(windows=windows)
    with pytest.raises(ValueError, match="generator died"):
        task.run()
    assert seen == []


def test_shutdown_stops_a_stream_task_at_its_next_window():
    log = []

    def fn(state, a):
        if state == 1:
            executor.shutdown(wait=False)
        return state + 1, (a,)

    old = executor.workers()
    task, seen = _window_task(n_windows=50, fn=fn, log=log)
    try:
        with pytest.raises(RuntimeError, match="aborted"):
            task.run()
    finally:
        executor.set_workers(old)
    assert seen == [0] and log[-1] == "closed"
    assert len([e for e in log if e[0] == "gen"]) == 3


def test_launch_counters_lose_no_update_across_threads():
    """Workers count their launches from many threads at once: with more
    threads than cores and a short switch interval, every count lands."""
    n_threads, per = 4 * (os.cpu_count() or 1), 1000

    def hammer():
        for _ in range(per):
            ops.check_launch("slot_scan", 0, "fast")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launches()
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        counted, by_variant = ops.launches(), ops.variants()
    finally:
        sys.setswitchinterval(old)
        ops.reset_launches()
    assert counted["slot_scan"] == n_threads * per
    assert by_variant == {"slot_scan/fast": n_threads * per}


# ---- Campaign.run against the JAX Campaign ----

def _trace_pair(seed, n, **kw):
    arrs = grid_trace(seed, n, **kw)
    return je.Trace.of(**arrs), interop.trace_from_arrays(**arrs), arrs


def _grid():
    """Five groups: bucket-64 ts and nots points, a bucket-128 Bloom point,
    a runtime policy point and a stream point (and its batched twin)."""
    ja, pa, arrs_a = _trace_pair(3, 44)
    jb, pb, arrs_b = _trace_pair(4, 70, kinds=2)
    jc_, pc_, _ = _trace_pair(5, 50, kinds=2, dep_max=2)
    bloom = trace_bloom([arrs_a, arrs_b])
    prog = jsmc.fcfs_program()
    jc, pc = JCampaign(), PCampaign()
    for c, a, b, s, pg, tr_mod in (
            (jc, ja, jb, jc_, prog, jtr),
            (pc, pa, pb, pc_, interop.policy_from_fields(
                **dataclasses.asdict(prog)), ptr)):
        sys_ = JN if c is jc else PSYS
        c.add(a, sys_, mode="ts", arm="a-ts")
        c.add(a, sys_, mode="nots", arm="a-nots")
        c.add(b, sys_, mode="ts", bloom=bloom, arm="b-bloom")
        c.add_policy_grid(a, sys_, [pg], arm="a-policy")
        c.add(lambda s=s, tr_mod=tr_mod: tr_mod.iter_windows(s, 20), sys_,
              stream=True, chunk=32, arm="c-stream")
        c.add(s, sys_, mode="reference", arm="c-batch")
    return jc, pc


def assert_records_equal(want, got, label=""):
    assert set(want) == set(got), (label, set(want) ^ set(got))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            np.testing.assert_array_equal(np.asarray(w), np.asarray(g),
                                          err_msg=f"{label} {k}")
        else:
            assert w == g, (label, k, w, g)


@pytest.fixture(scope="module")
def grid_runs():
    """The grid through JAX's Campaign and the port's, in order and
    overlapped (on two workers: on the CPU more threads only contend for
    the GIL)."""
    jc, pc = _grid()
    assert jc.n_groups() == pc.n_groups() == 5
    runs = {"jax": jc.run(serial=True, stream_collect="full"),
            "serial": pc.run(serial=True, stream_collect="full",
                             device=CPU)}
    old = executor.set_workers(2)
    try:
        runs["overlapped"] = pc.run(serial=False, stream_collect="full",
                                    device=CPU)
    finally:
        executor.set_workers(old)
    runs["last_run"] = pc.last_run
    return runs


@pytest.mark.parametrize("how", ["serial", "overlapped"])
def test_campaign_run_matches_jax(grid_runs, how):
    got = grid_runs[how]
    for w, g in zip(grid_runs["jax"], got):
        assert w["arm"] == g["arm"]
        assert_records_equal(w, g, f"{how} {g['arm']}")
    by = {r["arm"]: r for r in got}
    n = len(by["c-stream"]["t_resp"])
    np.testing.assert_array_equal(by["c-stream"]["t_resp"],
                                  by["c-batch"]["t_resp"][:n])
    assert int(by["c-stream"]["exec_cycles"]) == \
        int(by["c-batch"]["exec_cycles"])


def test_campaign_last_run_counts_groups(grid_runs):
    lr = grid_runs["last_run"]
    assert (lr["groups"], lr["loaded"], lr["computed"], lr["failed"]) \
        == (5, 0, 5, 0)
    assert lr["failures"] == []


def test_run_many_and_run_stream_many_overlapped_equal_serial():
    trs = [interop.trace_from_arrays(**grid_trace(20 + s, n))
           for s, n in enumerate((40, 40, 90))]
    modes = ["ts", "nots", "ts"]
    a = pe.run_many(trs, PSYS, modes, device=CPU, serial=True)
    b = pe.run_many(trs, PSYS, modes, device=CPU, serial=False)
    for x, y in zip(a, b):
        assert_records_equal(x, y)
    sa = pe.run_stream_many(trs[:2], PSYS, modes[:2], chunk=24, device=CPU,
                            serial=True)
    sb = pe.run_stream_many(trs[:2], PSYS, modes[:2], chunk=24, device=CPU,
                            serial=False)
    for x, y, whole in zip(sa, sb, a):
        assert_records_equal(x, y)
        np.testing.assert_array_equal(x["t_resp"], whole["t_resp"][:40])


def test_entry_points_reraise_a_single_failure_and_aggregate_several():
    good = interop.trace_from_arrays(**grid_trace(30, 40))
    bad = interop.trace_from_arrays([0], [16], [0], [1])
    with pytest.raises(ValueError, match="banks"):
        pe.run_many([good, bad], PSYS, device=CPU, serial=False)
    bad2 = interop.trace_from_arrays([0] * 80, [99] * 80, [0] * 80,
                                     [1] * 80)
    with pytest.raises(executor.ExecutionError, match="2 task"):
        pe.run_many([bad, bad2], PSYS, device=CPU)


def _ckpt_campaign(seed_b=41):
    pa = interop.trace_from_arrays(**grid_trace(40, 36))
    pb = interop.trace_from_arrays(**grid_trace(seed_b, 80))
    c = PCampaign()
    c.add(pa, PSYS, mode="ts", arm="a")
    c.add(pb, PSYS, mode="nots", arm="b")
    c.add(lambda: ptr.iter_windows(pa, 16), PSYS, stream=True, chunk=16,
          arm="s")
    return c


def _counting_scans(monkeypatch):
    calls = []
    orig = ops.slot_scan

    def counted(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(ops, "slot_scan", counted)
    return calls


def test_checkpoint_resume_recomputes_nothing(tmp_path, monkeypatch):
    calls = _counting_scans(monkeypatch)
    c = _ckpt_campaign()
    first = c.run(checkpoint=str(tmp_path), device=CPU)
    assert len(calls) == 2
    assert c.last_run["loaded"] == 0 and c.last_run["computed"] == 3
    files = sorted(os.listdir(tmp_path))
    # content-addressed: one file per batched group, none for the stream
    groups = {}
    for p in c.points:
        groups.setdefault(p.group_key(), []).append(p)
    want = sorted(f"group-{pcampaign._group_digest(k, pts)}.pkl"
                  for k, pts in groups.items() if not pts[0].stream)
    assert files == want
    # a new campaign over the same content loads both groups, launching
    # no slot scan; the stream group runs again
    again = _ckpt_campaign()
    second = again.run(checkpoint=str(tmp_path), device=CPU)
    assert len(calls) == 2
    assert (again.last_run["groups"], again.last_run["loaded"],
            again.last_run["computed"]) == (3, 2, 1)
    for x, y in zip(first, second):
        assert_records_equal(x, y, x["arm"])
    # other content, another address: only that group runs
    other = _ckpt_campaign(seed_b=42)
    other.run(checkpoint=str(tmp_path), device=CPU)
    assert len(calls) == 3 and other.last_run["loaded"] == 1
    assert len(os.listdir(tmp_path)) == 3
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_quarantine_completes_every_other_group(tmp_path, monkeypatch):
    good = interop.trace_from_arrays(**grid_trace(50, 40))
    poison = interop.trace_from_arrays([0] * 70, [99] * 70, [1] * 70,
                                       [1] * 70)
    c = PCampaign()
    c.add(good, PSYS, arm="good")
    c.add(poison, PSYS, arm="poison")
    c.add(poison, PSYS, arm="poison-too")
    recs = c.run(on_error="quarantine", checkpoint=str(tmp_path),
                 device=CPU)
    assert c.last_run["failed"] == 1 and c.last_run["computed"] == 1
    assert_records_equal(pe.run(good, PSYS, device=CPU),
                         {k: v for k, v in recs[0].items() if k != "arm"})
    for r in recs[1:]:
        assert r["error_type"] == "ValueError" and "banks" in r["error"]
        assert r["group"] == c.last_run["failures"][0].label
    # the default raises, after the good group was checkpointed
    calls = _counting_scans(monkeypatch)
    with pytest.raises(executor.ExecutionError, match="banks"):
        c.run(checkpoint=str(tmp_path), device=CPU)
    assert calls == [] and c.last_run["loaded"] == 1
    with pytest.raises(ValueError, match="on_error"):
        c.run(on_error="ignore", device=CPU)


def test_content_digest_matches_jax():
    ja, pa, arrs = _trace_pair(60, 48)
    bloom = trace_bloom([arrs])
    jprog = jsmc.write_drain_program()
    pprog = interop.policy_from_fields(**dataclasses.asdict(jprog))
    for kw_j, kw_p in (({}, {}),
                       (dict(mode="nots", bloom=bloom),
                        dict(mode="nots", bloom=bloom)),
                       (dict(policy=jprog, policy_cost=325),
                        dict(policy=pprog, policy_cost=325))):
        jp, pp = JPoint(ja, JN, **kw_j), PPoint(pa, PSYS, **kw_p)
        assert jp.content_digest() == pp.content_digest()
    assert PPoint(pa, PSYS).content_digest() != \
        PPoint(pa, PSYS, mode="nots").content_digest()
    with pytest.raises(ValueError, match="stream points"):
        PPoint(pa, PSYS, stream=True).content_digest()
