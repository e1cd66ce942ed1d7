"""The port's fault injection against the JAX package in one process: the
threefry draws (``core.threefry``), ``faults.apply_slot``, the RowHammer
trace, and the plain engine (``device="cpu"``) through run / run_many /
run_policies and ``RowHammerMitigationStudy``, on the fault model, system
and 96-request hammer trace of ``tests/test_faults.py``. Every int field,
every fault field and ``bit_error_rate`` must be equal.

The JAX side is computed once per module (``jax_runs``): its engine
compiles one scan per (config, batch, table bucket), a few seconds each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import emulator as je, faults as jfaults, smcprog as jsmc
from repro.core import techniques as jtech, traces as jtr
from repro.core.faults import FaultModel as JFault
from repro.core.timescale import JETSON_NANO as JN

from repro_torch import interop
from repro_torch.core import emulator as pe, faults as pfaults
from repro_torch.core import smcprog as psmc
from repro_torch.core import techniques as ptech, threefry, traces as ptr
from repro_torch.core.state import EmulatorState as PState
from repro_torch.kernels import ref as pref

torch.set_num_threads(1)

FM = JFault(seed=3, hammer_threshold=8, hammer_flip_fp=30000,
            weak_fp=16000, retention_ticks=30, victim_slots=16)
SYS = JN.with_faults(FM)
INT_FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
              "smc_fpga_cycles", "t_resp", "t_issue")
FAULT_FIELDS = pfaults.FAULT_SCALARS + pfaults.FAULT_LOGS
SEEDS = (0, 3, 7, 2 ** 31 - 1)
DATA = (0, 1, -1, 2 ** 30, 2 ** 31 - 1)
# the study's arms, tuned so that PARA and TRR fire on the hammer trace
STUDY_PROGS = dict(para_fp=3277, trr_threshold=4)


def port_sys(jsys):
    return interop.system_config_from_dict(dataclasses.asdict(jsys))


def port_prog(p):
    return interop.policy_from_fields(**dataclasses.asdict(p))


def port_trace(tr):
    return interop.trace_from_arrays(tr.kind, tr.bank, tr.row, tr.delta,
                                     tr.dep)


def hammer_trace(n=96, seed=5):
    return jtr.rowhammer_trace(n, JN.geometry, intensity=0.75, seed=seed)


def key_words(k):
    return tuple(int(x) for x in np.asarray(k))


def assert_same(a, b, label="", faults=True):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{label} {k}")
    if faults:
        for k in FAULT_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{label} {k}")
        assert float(a["bit_error_rate"]) == float(b["bit_error_rate"]), label


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine over the shared (trace, fault model), once."""
    tr = hammer_trace()
    mit = list(jsmc.mitigation_programs().values())
    tuned = list(jsmc.mitigation_programs(**STUDY_PROGS).values())
    para = jsmc.para_program(STUDY_PROGS["para_fp"])
    study = jtech.RowHammerMitigationStudy(JN, fault_model=FM)
    return {
        "tr": tr,
        "run": je.run(tr, SYS, "ts"),
        "many": je.run_many([tr, tr], SYS, "ts"),
        "mit": (mit, je.run_policies(tr, SYS, mit)),
        "tuned": (tuned, je.run_policies(tr, SYS, tuned)),
        "para_off": (para, je.run_policies(tr, JN, [para])[0]),
        "study": {axis: study.evaluate(n_requests=96, policy_axis=axis)
                  for axis in (True, False)},
    }


# ---- threefry: the derivations of jax.random, pinned

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_bits_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == key_words(k)
    for d in DATA:
        kd = jax.random.fold_in(k, jnp.int32(d))
        assert threefry.fold_in(threefry.prng_key(seed), d) == key_words(kd)
        assert threefry.bits32(key_words(kd)) == int(
            jax.random.bits(kd, (), jnp.uint32))


def test_threefry_counters_pinned_against_the_raw_hash():
    """fold_in hashes the counter (0, data) and bits32 the counter (0, 0),
    XOR of the two output words: JAX's raw threefry2x32 agrees."""
    from jax._src import prng
    for seed in SEEDS:
        k = jax.random.PRNGKey(seed)
        kw = key_words(k)
        for d in DATA:
            raw = prng.threefry_2x32(
                k, jnp.asarray([0, d & threefry.M32], jnp.uint32))
            assert threefry.threefry_2x32(*kw, 0, d & threefry.M32) == \
                tuple(int(x) for x in np.asarray(raw))
            assert threefry.fold_in(kw, d) == tuple(
                int(x) for x in np.asarray(raw))
        y = prng.threefry_2x32(k, jnp.zeros((2,), jnp.uint32))
        y0, y1 = (int(x) for x in np.asarray(y))
        assert threefry.bits32(kw) == y0 ^ y1
    # torch int64 words take the same path as Python ints
    d = torch.tensor(DATA, dtype=torch.int64)
    got = threefry.fold_in(threefry.prng_key(7), d)
    want = [threefry.fold_in(threefry.prng_key(7), x) for x in DATA]
    assert [(int(a), int(b)) for a, b in zip(*got)] == want


@pytest.mark.parametrize("seed", SEEDS)
def test_u16_and_para_draw_match_jax(seed):
    """``_u16`` and ``para_draw`` on banks x rows (row -1 and past int32's
    top included) at several DRAM times."""
    banks = np.array([0, 1, 15, 63, 4095], np.int32)
    rows = np.array([-1, 0, 1, 127, 32767, 2 ** 31 - 1], np.int32)
    b, r = (x.ravel() for x in np.meshgrid(banks, rows))
    for now in (0, 9359, 2 ** 30):
        want = np.asarray(jfaults.para_draw(seed, jnp.asarray(b),
                                            jnp.asarray(r), jnp.int32(now)))
        got = pfaults.para_draw(seed, torch.from_numpy(b),
                                torch.from_numpy(r), torch.tensor(now))
        np.testing.assert_array_equal(got.numpy(), want)
    for d in DATA:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(d))
        assert int(pfaults._u16(key_words(k))) == int(jfaults._u16(k))


# ---- apply_slot on random carries

APPLY_CASES = {
    "both": {},
    "hammer-only": {"weak_fp": 0},
    "retention-only": {"hammer_threshold": 0},
    "neither": {"hammer_threshold": 0, "weak_fp": 0},
    "log-at-capacity": {"victim_slots": 2, "full": True},
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_apply_slot_matches_jax(case):
    c = dict(APPLY_CASES[case])
    full = c.pop("full", False)
    fm = dataclasses.replace(FM, hammer_threshold=c.get("hammer_threshold",
                                                        3),
                             hammer_flip_fp=40000, weak_fp=c.get(
                                 "weak_fp", 40000), **{
                                 k: v for k, v in c.items()
                                 if k == "victim_slots"})
    pfm = pfaults.FaultModel(**dataclasses.asdict(fm))
    rng = np.random.RandomState(sorted(APPLY_CASES).index(case))
    B, nb, n_rows, tREFI, V = 24, 8, 64, 97, fm.victim_slots
    st = {
        "hct": rng.randint(0, 5, (B, nb)),
        "vptr": rng.randint(V, V + 3, B) if full else rng.randint(0, V, B),
        "ham_flips": rng.randint(0, 9, B), "ret_flips": rng.randint(0, 9, B),
        "mitigations": rng.randint(0, 9, B),
    }
    for k in ("vbank", "vrow", "vt"):
        st[k] = np.where(np.arange(V) < st["vptr"][:, None],
                         rng.randint(0, 50, (B, V)), -1)
    slot = {
        "do": rng.rand(B) < 0.8, "hit": rng.rand(B) < 0.3,
        "bank": rng.randint(0, nb, B),
        "row": rng.choice([0, 1, 31, n_rows - 1], B),
        "kind": rng.randint(0, 5, B), "t_start": rng.randint(0, 5000, B),
        "refreshed": rng.rand(B) < 0.2, "mitigate": rng.rand(B) < 0.3,
    }
    ints = {k: np.asarray(v, np.int32) for k, v in st.items()}
    pst = {k: torch.from_numpy(v) for k, v in ints.items()}
    pslot = {k: torch.from_numpy(v if v.dtype == bool else v.astype(np.int32))
             for k, v in slot.items()}
    got, extra = pfaults.apply_slot(pfm, n_rows, tREFI, 56, pst, **pslot)
    for i in range(B):
        jst = {k: jnp.asarray(v[i]) for k, v in ints.items()}
        jslot = {k: jnp.asarray(v[i]) for k, v in slot.items()}
        want, wextra = jfaults.apply_slot(fm, n_rows, tREFI, 56, jst,
                                          **jslot)
        for k in want:
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(want[k]),
                                          err_msg=f"{case} row {i} {k}")
        assert int(extra[i]) == int(wextra), (case, i)
    if case == "both":   # both processes fired somewhere on this grid
        assert int((got["ham_flips"] - pst["ham_flips"]).sum()) > 0
        assert int((got["ret_flips"] - pst["ret_flips"]).sum()) > 0


@pytest.mark.parametrize("seed,intensity,double_sided",
                         [(0, 0.8, True), (5, 0.75, True), (1, 0.0, True),
                          (2, 1.0, False), (9, 0.45, False)])
def test_rowhammer_trace_matches_jax(seed, intensity, double_sided):
    kw = dict(intensity=intensity, double_sided=double_sided, seed=seed)
    a = jtr.rowhammer_trace(300, JN.geometry, **kw)
    b = ptr.rowhammer_trace(300, port_sys(JN).geometry, **kw)
    for f in ("kind", "bank", "row", "delta", "dep"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


# ---- the plain engine against the JAX engine

def test_run_matches_jax_and_both_processes_fire(jax_runs):
    got = pe.run(port_trace(jax_runs["tr"]), port_sys(SYS), device="cpu")
    assert_same(got, jax_runs["run"], "run")
    assert int(got["ham_flips"]) > 0 and int(got["ret_flips"]) > 0
    assert int(got["flips"]) == int(got["ham_flips"]) + int(got["ret_flips"])


def test_run_many_matches_jax(jax_runs):
    pt = port_trace(jax_runs["tr"])
    got = pe.run_many([pt, pt], port_sys(SYS), device="cpu")
    for a, b in zip(got, jax_runs["many"]):
        assert_same(a, b, "run_many")


@pytest.mark.parametrize("arms", ["mit", "tuned"])
def test_run_policies_mitigation_programs_match_jax(jax_runs, arms):
    progs, want = jax_runs[arms]
    got = pe.run_policies(port_trace(jax_runs["tr"]), port_sys(SYS),
                          [port_prog(p) for p in progs], device="cpu")
    for p, a, b in zip(progs, got, want):
        assert_same(a, b, p.name)
    if arms == "tuned":   # PARA and TRR fired, TRR held the hammer back
        assert all(int(r["mitigations"]) > 0 for r in got[1:])
        assert int(got[2]["ham_flips"]) < int(got[0]["ham_flips"])


def test_para_program_without_a_fault_model(jax_runs):
    """para_rand draws under seed 0 without a fault model, as in JAX; the
    result has no fault fields."""
    para, want = jax_runs["para_off"]
    got = pe.run_policies(port_trace(jax_runs["tr"]), port_sys(JN),
                          [port_prog(para)], device="cpu")[0]
    assert_same(got, want, "para", faults=False)
    assert "flips" not in got and "bit_error_rate" not in got


def test_para_rand_loads_zero_off_the_fault_path():
    """The plain engine draws para_rand only on the fault path
    (``ScanParams.faults``, which the engine sets for a table that loads
    it), as both kernel instantiations do: off it, a program scoring by
    para_rand schedules as one scoring by 0; on it the draws reorder the
    service."""
    rng = np.random.RandomState(1)
    B, n = 2, 96
    arrs = [torch.from_numpy(a.astype(np.int32)) for a in (
        rng.randint(0, 4, (B, n)), rng.randint(0, 16, (B, n)),
        rng.randint(0, 64, (B, n)), rng.randint(0, 24, (B, n)),
        np.zeros((B, n)))]
    costs = torch.tensor([[520, 260]] * B, dtype=torch.int32)
    sys_ = dataclasses.replace(port_sys(JN), window=8)

    def run(score, para):
        b = psmc.PolicyBuilder()
        v = b.para_rand() if score == "para_rand" else b.const(0)
        prog = b.build(score=v, boost=b.score_row_hit(), name=score)
        tables = torch.from_numpy(psmc.pack_stack([prog] * B, 8))
        p = pe._scan_params(sys_, "nots", B, n, 2 * n + 4, 8, False, para)
        assert p.faults == int(para)
        return pref.slot_scan_ref(*arrs, None, tables, costs, p)

    off, zero = run("para_rand", False), run("zero", False)
    for f in zero:
        assert torch.equal(off[f], zero[f]), f
    assert not torch.equal(run("para_rand", True)["t_resp"], off["t_resp"])


def test_fault_free_results_have_no_fault_fields(jax_runs):
    off = pe.run(port_trace(jax_runs["tr"]), port_sys(JN), device="cpu")
    assert not set(FAULT_FIELDS + ("bit_error_rate",)) & set(off)
    # without a mitigating policy, faults never perturb the schedule
    assert int(off["exec_cycles"]) == int(jax_runs["run"]["exec_cycles"])
    assert pe.group_key(96, port_sys(SYS), "ts", None) != \
        pe.group_key(96, port_sys(JN), "ts", None)


@pytest.mark.parametrize("policy_axis", [True, False])
def test_mitigation_study_matches_jax(jax_runs, policy_axis):
    study = ptech.RowHammerMitigationStudy(
        port_sys(JN), fault_model=pfaults.FaultModel(
            **dataclasses.asdict(FM)))
    got = study.evaluate(n_requests=96, policy_axis=policy_axis,
                         device="cpu")
    assert got == jax_runs["study"][policy_axis]
    assert any(d[n]["mitigations"] > 0 for d in got for n in d
               if n != "intensity")
    with pytest.raises(NotImplementedError, match="Queue A 9"):
        study.evaluate(n_requests=96, device="cpu", checkpoint="x")


def test_state_round_trip_with_fault_carry():
    jst = je.EmulatorState.init(20, SYS)
    host = jst.to_host()
    st = interop.EmulatorState.from_host(host)
    back = st.to_host()
    assert set(back["faults"]) == set(host["faults"])
    for k, v in host["faults"].items():
        np.testing.assert_array_equal(back["faults"][k], v, err_msg=k)
    fresh = PState.init(20, port_sys(SYS)).to_host()
    for k, v in host["faults"].items():
        np.testing.assert_array_equal(fresh["faults"][k], v, err_msg=k)
    assert PState.init(20, port_sys(JN)).faults == {}
