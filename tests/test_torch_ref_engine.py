"""The port's reference engine and batch-axis sharding against the JAX
package on the CPU.

``run_ref`` / ``run_ref_many`` (the plain ``ref_scan_ref`` on the CPU) must
equal JAX's ``run_ref_many`` exactly on every field, over the cases that
``chip_smoke.py`` phase 7f holds the ``ref_scan`` kernel to on the card (at
24-32 requests here): ts and reference with a shared Bloom filter, runtime
policy tables in nots with a Bloom filter per trace (PARA without a fault
model among them), a fault model under the legacy scheduler and under the
mitigation programs, a staged policy, and a window of 80 over 128 banks.
They must also equal the port's own fast engine (``run == run_ref``). The
plan cache's counters must equal JAX's over a sequence of run, run_ref and
set_sharding calls; forced and two-device sharded runs must equal JAX's
unsharded records (JAX's own forced sharding fails on a CPU-only host, so
it is not the yardstick).

Phase 7f's 512-row table is left to the card: the plain engine spends ~30
CPU-s on it. Both plain engines make their decision in one function
(``kernels/ref.py`` ``_decide``), which ``tests/test_torch_limits.py``
holds against JAX at a 512-row table.

The JAX side is computed once per module (``jax_runs``: six compiles of
the reference engine and one of the fast engine, ~25 s).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import emulator as je, smcprog as jsmc
from repro.core.bloom import BloomFilter
from repro.core.faults import FaultModel
from repro.core.timescale import JETSON_NANO as JN

from repro_torch import interop
from repro_torch.core import emulator as pe
from repro_torch.kernels import ops

torch.set_num_threads(1)

FM = FaultModel(seed=7, hammer_threshold=8, hammer_flip_fp=52000,
                weak_fp=16000, retention_ticks=30, victim_slots=16)
WIDE = dataclasses.replace(
    JN, window=80, geometry=dataclasses.replace(JN.geometry, n_banks=128))


def trace(rng, n, n_banks=16, rows=64, kinds=(0, 1, 2, 4)):
    return je.Trace.of(kind=rng.choice(kinds, n),
                       bank=rng.randint(0, n_banks, n),
                       row=rng.randint(0, rows, n),
                       delta=rng.randint(0, 30, n), dep=rng.randint(0, 4, n))


def bloom(rng, m_bits, k):
    keys = rng.randint(0, 16 * 64, 300).astype(np.uint32)
    bf = BloomFilter.build(keys, m_bits=m_bits, k=k)
    return (bf.bits, bf.k, bf.m_bits)


def cases():
    """name -> (traces, sys, run_ref_many keywords): JAX objects, every
    trace 24-32 requests (one 32-request bucket)."""
    rng = np.random.RandomState(23)
    trs = [trace(rng, n) for n in (28, 32, 24, 30)]
    progs = (list(jsmc.builtin_programs().values())
             + list(jsmc.mitigation_programs(para_fp=20000,
                                             trr_threshold=3).values()))
    storms = [trace(rng, n, rows=3, kinds=(0, 0, 1)) for n in (32, 26)]
    mit = list(jsmc.mitigation_programs(para_fp=20000,
                                        trr_threshold=3).values())
    return {
        "modes-shared-bloom": (trs, JN, dict(
            mode=["ts", "reference", "ts", "reference"],
            blooms=bloom(rng, 1 << 12, 3))),
        "policies-bloom-per-trace": ([trs[0]] * len(progs), JN, dict(
            mode="nots", blooms=[bloom(rng, 1 << 11, 4) for _ in progs],
            policies=progs,
            policy_costs=[p.smc_cycles() for p in progs])),
        "faults-legacy": (storms, JN.with_faults(FM), {}),
        "faults-mitigation-policies": ([storms[0]] * len(mit),
                                       JN.with_faults(FM), dict(
            policies=mit, policy_costs=[p.smc_cycles() for p in mit])),
        "staged-policy": (trs[:2], JN.with_policy(
            jsmc.builtin_programs()["bank-rr"]), dict(mode="nots")),
        "wide-q80-banks128": (
            [trace(rng, n, n_banks=128) for n in (32, 25)], WIDE,
            dict(policies=progs[:2], policy_costs=[40, 160])),
    }


def port_args(trs, sys, kw):
    ptrs = [interop.trace_from_arrays(t.kind, t.bank, t.row, t.delta, t.dep)
            for t in trs]
    psys = interop.system_config_from_dict(dataclasses.asdict(sys))
    pkw = dict(kw)
    if "policies" in kw:
        pkw["policies"] = [interop.policy_from_fields(**dataclasses.asdict(p))
                           for p in kw["policies"]]
    return ptrs, psys, pkw


def records_equal(a, b, label):
    assert len(a) == len(b), label
    for i, (x, y) in enumerate(zip(a, b)):
        assert set(x) == set(y), f"{label} record {i}"
        for k, v in x.items():
            w = y[k]
            if isinstance(v, (np.ndarray, np.generic)):
                np.testing.assert_array_equal(
                    np.asarray(v), np.asarray(w),
                    err_msg=f"{label} record {i} {k}")
            else:
                assert v == w, f"{label} record {i} {k}: {v} != {w}"


def cache_sequence(emu, run_many, run_ref_many, trs, sys):
    """cache_stats after each of: run, run_ref, run_ref, run under 'force'
    and under 'off' (a call that raises still counts its lookup)."""
    snaps = []
    emu.cache_clear()
    old = emu.set_sharding("auto")
    try:
        for mode, fn in (("auto", run_many), ("auto", run_ref_many),
                         ("auto", run_ref_many), ("force", run_many),
                         ("off", run_many)):
            emu.set_sharding(mode)
            try:
                fn(trs, sys)
            except Exception:
                pass
            st = emu.cache_stats()
            snaps.append((st["hits"], st["misses"], st["size"]))
    finally:
        emu.set_sharding(old)
    return snaps


@pytest.fixture(scope="module")
def jax_runs():
    out = {"cases": {}}
    all_cases = cases()
    trs, sys, _ = all_cases["staged-policy"]
    out["cache"] = cache_sequence(
        je, lambda t, s: je.run_many(t, s),
        lambda t, s: je.run_ref_many(t, s), trs, sys)
    for name, (trs, sys, kw) in all_cases.items():
        out["cases"][name] = je.run_ref_many(trs, sys, **kw)
    return out


@pytest.fixture(scope="module")
def port_runs():
    """The port's run_ref_many and run_many of every case (plain engines)."""
    out = {}
    for name, (trs, sys, kw) in cases().items():
        ptrs, psys, pkw = port_args(trs, sys, kw)
        out[name] = (pe.run_ref_many(ptrs, psys, device="cpu", **pkw),
                     pe.run_many(ptrs, psys, device="cpu", **pkw))
    return out


@pytest.mark.parametrize("case", list(cases()))
def test_run_ref_many_matches_jax(case, jax_runs, port_runs):
    records_equal(port_runs[case][0], jax_runs["cases"][case],
                  f"{case}: port run_ref_many vs JAX")


@pytest.mark.parametrize("case", list(cases()))
def test_run_ref_equals_run(case, port_runs):
    """The property the reference engine exists for: run == run_ref."""
    ref, fast = port_runs[case]
    records_equal(ref, fast, f"{case}: run_ref_many vs run_many")


def test_run_ref_single_trace_matches_jax(jax_runs):
    trs, sys, kw = cases()["modes-shared-bloom"]
    ptrs, psys, _ = port_args(trs, sys, {})
    got = pe.run_ref(ptrs[1], psys, "reference", bloom=kw["blooms"],
                     device="cpu")
    records_equal([got], [jax_runs["cases"]["modes-shared-bloom"][1]],
                  "run_ref")


def test_cache_stats_match_jax_over_run_run_ref_and_sharding(jax_runs):
    trs, sys, _ = cases()["staged-policy"]
    ptrs, psys, _ = port_args(trs, sys, {})
    got = cache_sequence(
        pe, lambda t, s: pe.run_many(t, s, device="cpu"),
        lambda t, s: pe.run_ref_many(t, s, device="cpu"), ptrs, psys)
    assert got == jax_runs["cache"]
    # the plan cache forks on the engine and the shard count
    assert got == [(0, 1, 1), (0, 2, 2), (1, 2, 2), (1, 3, 3), (2, 3, 3)]


def test_set_sharding_validates_and_shard_count(monkeypatch):
    with pytest.raises(ValueError, match="sharding mode"):
        pe.set_sharding("sometimes")
    old = pe.set_sharding("off")
    try:
        assert pe._shard_count(8, "cpu") == 0
        pe.set_sharding("auto")
        assert pe._shard_count(8, "cpu") == 0        # one CPU device
        pe.set_sharding("force")
        assert pe._shard_count(8, "cpu") == 1
        two = [torch.device("cpu")] * 2
        monkeypatch.setattr(pe, "local_devices", lambda device_type: two)
        pe.set_sharding("auto")
        assert [pe._shard_count(b, "cpu") for b in (1, 2, 4, 8)] == \
            [0, 2, 2, 2]
        pe.set_sharding("off")
        assert pe._shard_count(8, "cpu") == 0
    finally:
        pe.set_sharding(old)


# the batch of each launch: the modes case is one 4-row ts / reference
# group, the policy case one 16-row group
SHARD_BATCHES = {
    ("modes-shared-bloom", 1): [4], ("modes-shared-bloom", 2): [2, 2],
    ("policies-bloom-per-trace", 2): [8, 8],
}


@pytest.mark.parametrize("case,devices,mode", [
    ("modes-shared-bloom", 1, "force"), ("modes-shared-bloom", 2, "auto"),
    ("policies-bloom-per-trace", 2, "auto")])
def test_sharded_runs_equal_jax_unsharded(case, devices, mode, jax_runs,
                                          monkeypatch):
    """'force' on the one CPU device, and two devices (the lister
    monkeypatched): each shard's rows launch apart (a shared filter goes
    to every shard, stacked filters, tables and costs split), and run_ref
    and run records equal JAX's unsharded ones."""
    monkeypatch.setattr(pe, "local_devices",
                        lambda device_type: [torch.device("cpu")] * devices)
    batches = {"ref_scan": [], "slot_scan": []}
    for name in batches:
        orig = getattr(ops, name)

        def spy(*args, orig=orig, name=name):
            batches[name].append(args[-1].batch)
            return orig(*args)
        monkeypatch.setattr(ops, name, spy)
    trs, sys, kw = cases()[case]
    ptrs, psys, pkw = port_args(trs, sys, kw)
    old = pe.set_sharding(mode)
    try:
        ref = pe.run_ref_many(ptrs, psys, device="cpu", serial=True, **pkw)
        fast = pe.run_many(ptrs, psys, device="cpu", serial=True, **pkw)
    finally:
        pe.set_sharding(old)
    want = jax_runs["cases"][case]
    records_equal(ref, want, f"{case} {mode} x{devices}: run_ref_many")
    records_equal(fast, want, f"{case} {mode} x{devices}: run_many")
    expect = SHARD_BATCHES[(case, devices)]
    assert batches == {"ref_scan": expect, "slot_scan": expect}
