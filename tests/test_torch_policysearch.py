"""The port's policy search, ``SchedulingPolicyStudy`` and the LM-side
trace generators on the CPU, against the JAX package in one process:
``random_program`` / ``mutate`` / ``crossover`` draw the reference's
programs from the same seeds (table, outputs, name and digest);
``search`` on the plain engine (``device="cpu"``) finds the reference's
result (best digest, fitness, history, leaderboard, summary) and raises
its errors; the study equals the reference's for both cost treatments;
``lm_decode_trace`` and ``kv_fork_trace`` give the reference's arrays."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import policysearch as jps, smcprog as jsmc
from repro.core import techniques as jtech, traces as jtr
from repro.core.dram import Geometry as JGeometry
from repro.core.emulator import Trace as JTrace
from repro.core.timescale import JETSON_NANO as JN
from tests.conftest import tiny_cfg

from repro_torch import configs as pconfigs, interop
from repro_torch.core import policysearch as pps, smcprog as psmc
from repro_torch.core import techniques as ptech, traces as ptr
from repro_torch.core.dram import Geometry as PGeometry

from test_torch_engine import grid_trace

torch.set_num_threads(1)
CPU = "cpu"
PSYS = interop.system_config_from_dict(dataclasses.asdict(JN))


def same_program(j, p):
    assert tuple(map(tuple, j.table)) == tuple(map(tuple, p.table))
    assert (j.score_reg, j.boost_reg, j.mitigate_reg, j.name) == \
        (p.score_reg, p.boost_reg, p.mitigate_reg, p.name)
    assert j.digest == p.digest
    np.testing.assert_array_equal(jsmc.pack_program(j), psmc.pack_program(p))


def port_prog(j):
    return interop.policy_from_fields(**dataclasses.asdict(j))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_program_draws_match_jax(seed):
    """One RandomState per side, the same calls in the same order: every
    draw, mutation and crossover equals the reference's."""
    jr, pr = np.random.RandomState(seed), np.random.RandomState(seed)
    for max_ops in (2, 5, 8):
        ja = jps.random_program(jr, max_ops, name="a")
        pa = pps.random_program(pr, max_ops, name="a")
        same_program(ja, pa)
        jb = jps.random_program(jr, max_ops, name="b")
        pb = pps.random_program(pr, max_ops, name="b")
        for k in range(6):
            ja = jps.mutate(ja, jr, max_ops, name=f"m{k}")
            pa = pps.mutate(pa, pr, max_ops, name=f"m{k}")
            same_program(ja, pa)
            assert pa.n_ops <= max_ops
        same_program(jps.crossover(ja, jb, jr), pps.crossover(pa, pb, pr))
    assert jr.randint(1 << 30) == pr.randint(1 << 30)


def test_seed_population_matches_jax():
    seeds = list(jsmc.builtin_programs().values())
    jpop = jps._seed_population(np.random.RandomState(3), 12, 8, seeds,
                                seeds[0])
    ppop = pps._seed_population(np.random.RandomState(3), 12, 8,
                                [port_prog(p) for p in seeds],
                                port_prog(seeds[0]))
    assert len(jpop) == len(ppop) == 12
    for j, p in zip(jpop, ppop):
        same_program(j, p)


@pytest.fixture(scope="module")
def search_trace():
    arrs = grid_trace(77, 200, kinds=2, dep_max=2)
    return JTrace.of(**arrs), interop.trace_from_arrays(**arrs)


def test_search_matches_jax(search_trace):
    jt, pt = search_trace
    kw = dict(generations=2, population=6, seed=5, mode="ts")
    want = jps.search(jt, JN, serial=True, **kw)
    got = pps.search(pt, PSYS, device=CPU, **kw)
    same_program(want.best, got.best)
    same_program(want.baseline, got.baseline)
    assert got.best_fitness == want.best_fitness
    assert got.baseline_fitness == want.baseline_fitness
    assert got.history == want.history
    assert got.leaderboard == want.leaderboard
    assert (got.n_evaluated, got.n_dispatches) == \
        (want.n_evaluated, want.n_dispatches)
    assert got.improvement == want.improvement >= 1.0
    assert got.summary() == want.summary()


@pytest.mark.parametrize("kw,match", [
    (dict(population=1), "population"), (dict(elite=0), "elite"),
    (dict(max_ops=1), "max_ops"), (dict(baseline="nope"), "baseline")])
def test_search_errors_match_jax(search_trace, kw, match):
    jt, pt = search_trace
    with pytest.raises(ValueError, match=match) as je_:
        jps.search(jt, JN, **kw)
    with pytest.raises(ValueError, match=match) as pe_:
        pps.search(pt, PSYS, device=CPU, **kw)
    assert str(je_.value) == str(pe_.value)


@pytest.mark.parametrize("derive_cost", [True, False])
def test_scheduling_policy_study_matches_jax(derive_cost):
    arrs = [grid_trace(80 + s, 56, kinds=2) for s in range(2)]
    jtrs = [JTrace.of(**a) for a in arrs]
    ptrs = [interop.trace_from_arrays(**a) for a in arrs]
    want = jtech.SchedulingPolicyStudy(JN).evaluate_traces(
        jtrs, mode="nots", derive_cost=derive_cost)
    got = ptech.SchedulingPolicyStudy(PSYS).evaluate_traces(
        ptrs, mode="nots", derive_cost=derive_cost, device=CPU)
    assert got == want
    assert set(got[0]) == set(psmc.builtin_programs())
    with pytest.raises(ValueError, match="unique"):
        ptech.SchedulingPolicyStudy(PSYS, [psmc.fcfs_program()] * 2)
    with pytest.raises(ValueError, match="at least one"):
        ptech.SchedulingPolicyStudy(PSYS, [])


def _same_trace(j, p):
    for f in ("kind", "bank", "row", "delta", "dep"):
        np.testing.assert_array_equal(getattr(j, f), getattr(p, f),
                                      err_msg=f)


@pytest.mark.parametrize("seq_len,max_requests", [(64, 3000), (1024, 400)])
def test_lm_decode_trace_matches_jax(seq_len, max_requests):
    jcfg = tiny_cfg("qwen3_8b")
    pcfg = pconfigs.ArchConfig(**dataclasses.asdict(jcfg))
    want = jtr.lm_decode_trace(jcfg, seq_len, JGeometry(),
                               max_requests=max_requests)
    got = ptr.lm_decode_trace(pcfg, seq_len, PGeometry(),
                              max_requests=max_requests)
    assert got.n > 0
    _same_trace(want, got)
    # an MoE arch streams its active share of the parameters
    jmoe = tiny_cfg("qwen3_moe_30b_a3b")
    pmoe = pconfigs.get_config("qwen3_moe_30b_a3b").scaled(
        **{k: getattr(jmoe, k) for k in ("n_layers", "d_model", "n_heads",
                                         "n_kv_heads", "d_ff", "vocab_size",
                                         "head_dim")})
    got = ptr.lm_decode_trace(pmoe, seq_len, PGeometry(),
                              max_requests=max_requests)
    assert got.n > 0
    _same_trace(jtr.lm_decode_trace(jmoe, seq_len, JGeometry(),
                                    max_requests=max_requests), got)


@pytest.mark.parametrize("mode", ["cpu", "rowclone"])
def test_kv_fork_trace_matches_jax(mode):
    want, wmeta = jtr.kv_fork_trace(6, 16384, JGeometry(), mode)
    got, gmeta = ptr.kv_fork_trace(6, 16384, PGeometry(), mode)
    _same_trace(want, got)
    assert wmeta == gmeta
