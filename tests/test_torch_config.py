"""The PyTorch port's host-side layers against the JAX reference, in one
process on the same numpy inputs: SystemConfig and its derived integers,
the DRAM bank state machine, Bloom filter words, the device model,
workload traces, policy programs (digests, packing) and the engine
state. Every comparison is exact."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dram as jdram, smcprog as jsmc, traces as jtraces
from repro.core import timescale as jts
from repro.core.bloom import BloomFilter as JBloom
from repro.core.emulator import EmulatorState as JState
from repro.core.policysearch import random_program
from repro.core.profiling import DeviceModel as JDevice

from repro_torch import interop
from repro_torch.core import dram as pdram, smcprog as psmc
from repro_torch.core import timescale as pts, traces as ptraces
from repro_torch.core.bloom import BloomFilter as PBloom
from repro_torch.core.profiling import DeviceModel as PDevice
from repro_torch.core.state import EmulatorState as PState

torch.set_num_threads(1)

DERIVED = ("proc_per_tick_emu", "proc_per_tick_fpga", "hwmc_latency_proc",
           "hwmc_issue_proc", "smc_latency_fpga_proc")


def port_sys(jsys):
    return interop.system_config_from_dict(dataclasses.asdict(jsys))


def port_prog(p):
    return interop.policy_from_fields(**dataclasses.asdict(p))


def random_configs(n=24, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append(jts.SystemConfig(
            f_proc_emu_ghz=float(rng.uniform(0.3, 4.0)),
            hwmc_latency_ns=float(rng.uniform(0.0, 80.0)),
            hwmc_issue_ns=float(rng.uniform(0.1, 10.0)),
            f_proc_fpga_mhz=float(rng.uniform(10.0, 400.0)),
            f_mc_fpga_mhz=float(rng.uniform(10.0, 400.0)),
            smc_cycles_per_decision=int(rng.randint(0, 2000)),
            smc_transfer_cycles=int(rng.randint(0, 500)),
            window=int(rng.randint(1, 17)),
            scheduler=("frfcfs", "fcfs")[rng.randint(2)]))
    return out


@pytest.mark.parametrize("name", ["JETSON_NANO", "PIDRAM_LIKE",
                                  "VALIDATION_1GHZ"])
def test_presets_equal(name):
    j, p = getattr(jts, name), getattr(pts, name)
    assert port_sys(j) == p
    assert hash(port_sys(j)) == hash(p)
    for f in DERIVED:
        assert getattr(j, f) == getattr(p, f), f


def test_derived_properties_random_configs():
    for j in random_configs():
        p = port_sys(j)
        for f in DERIVED:
            assert getattr(j, f) == getattr(p, f), f
        for mode in ("ts", "nots", "reference"):
            assert j.cycles_to_seconds(123457, mode) == \
                p.cycles_to_seconds(123457, mode)
            assert j.dram_ticks_to_proc(9999, mode) == \
                p.dram_ticks_to_proc(9999, mode)


def test_with_policy_and_faults_carry_over():
    prog = jsmc.bank_round_robin_program()
    j = jts.JETSON_NANO.with_policy(prog)
    p = pts.JETSON_NANO.with_policy(port_prog(prog))
    assert port_sys(j) == p
    assert p.smc_cycles_per_decision == j.smc_cycles_per_decision
    from repro.core.faults import FaultModel as JFault
    from repro_torch.core.faults import FaultModel as PFault
    jf = jts.JETSON_NANO.with_faults(JFault(seed=3, hammer_threshold=9))
    assert port_sys(jf) == pts.JETSON_NANO.with_faults(
        PFault(seed=3, hammer_threshold=9))
    with pytest.raises(ValueError):
        PFault(weak_fp=70000).validate()


def random_bank_states(rng, b, nb=16):
    return {
        "open_row": rng.randint(-1, 6, (b, nb)).astype(np.int32),
        "ready": rng.randint(0, 40000, (b, nb)).astype(np.int32),
        "act_at": rng.randint(0, 40000, (b, nb)).astype(np.int32),
        "bus_busy": rng.randint(0, 40000, b).astype(np.int32),
        "refs_done": rng.randint(0, 5, b).astype(np.int32),
    }


@pytest.mark.parametrize("trcd", [17, 11])
def test_service_request_field_by_field(trcd):
    rng = np.random.RandomState(trcd)
    B = 64
    bs = random_bank_states(rng, B)
    kind = rng.randint(0, 4, B).astype(np.int32)
    bank = rng.randint(0, 16, B).astype(np.int32)
    row = rng.randint(0, 6, B).astype(np.int32)
    now = rng.randint(0, 60000, B).astype(np.int32)
    t = jdram.Timing()
    pbs, pdone, phit = pdram.service_request(
        {k: torch.from_numpy(v) for k, v in bs.items()}, pdram.Timing(),
        torch.from_numpy(kind), torch.from_numpy(bank), torch.from_numpy(row),
        torch.from_numpy(now), torch.full((B,), trcd, dtype=torch.int32))
    for i in range(B):
        jb = {k: jnp.asarray(v[i]) for k, v in bs.items()}
        nbs, done, hit = jdram.service_request(
            jb, t, jnp.int32(kind[i]), jnp.int32(bank[i]), jnp.int32(row[i]),
            jnp.int32(now[i]), jnp.int32(trcd))
        assert int(done) == int(pdone[i])
        assert bool(hit) == bool(phit[i])
        for k in bs:
            np.testing.assert_array_equal(np.asarray(nbs[k]),
                                          pbs[k][i].numpy(), err_msg=k)


def test_bank_state_and_neighbor_refresh():
    geo = jdram.Geometry()
    jb = jdram.init_bank_state(geo)
    pb = pdram.init_bank_state(pdram.Geometry())
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), pb[k].numpy())
    assert jdram.neighbor_refresh_ticks(jdram.Timing()) == \
        pdram.neighbor_refresh_ticks(pdram.Timing())
    np.testing.assert_array_equal(np.asarray(jdram.Timing().as_array()),
                                  pdram.Timing().as_array().numpy())


@pytest.mark.parametrize("m_bits,k", [(1 << 14, 2), (1 << 16, 4), (1 << 20, 4)])
def test_bloom_words_byte_identical(m_bits, k):
    keys = np.random.RandomState(k).randint(0, 1 << 24, 3000).astype(np.uint32)
    jb, pb = JBloom.build(keys, m_bits, k), PBloom.build(keys, m_bits, k)
    assert jb.bits.tobytes() == pb.bits.tobytes()
    probe = np.arange(5000, dtype=np.uint32)
    np.testing.assert_array_equal(jb.contains(probe), pb.contains(probe))
    assert interop.bloom_from_words(jb.bits, m_bits, k).bits.tobytes() == \
        jb.bits.tobytes()


@pytest.mark.parametrize("geo_kw", [{}, {"n_banks": 4, "n_rows": 4096}])
def test_device_model_byte_identical(geo_kw):
    jd = JDevice(jdram.Geometry(**geo_kw), seed=3)
    pd = PDevice(pdram.Geometry(**geo_kw), seed=3)
    assert jd.weak.tobytes() == pd.weak.tobytes()
    assert jd.weak_rows().tobytes() == pd.weak_rows().tobytes()
    assert jd.min_trcd_ns.tobytes() == pd.min_trcd_ns.tobytes()
    for args in [(0, 64, 65), (3, 100, 300), (1, 511, 600), (2, 7, 7)]:
        assert jd.clonable(*args) == pd.clonable(*args)


def same_trace(a, b):
    for f in ("kind", "bank", "row", "delta", "dep"):
        assert np.asarray(getattr(a, f)).tobytes() == \
            np.asarray(getattr(b, f)).tobytes(), f


@pytest.mark.parametrize("idx", [0, 3, 12, 16, 20])
def test_polybench_traces_byte_identical(idx):
    jt, jn = jtraces.polybench_trace(jtraces.POLYBENCH[idx], jdram.Geometry(),
                                     max_accesses=400)
    pt, pn = ptraces.polybench_trace(ptraces.POLYBENCH[idx], pdram.Geometry(),
                                     max_accesses=400)
    assert jn == pn
    same_trace(jt, pt)


@pytest.mark.parametrize("gen", ["copy_workload", "init_workload"])
@pytest.mark.parametrize("mode", ["cpu", "rowclone"])
@pytest.mark.parametrize("setting", ["noflush", "clflush"])
def test_rowclone_workloads_byte_identical(gen, mode, setting):
    jdev = JDevice(jdram.Geometry())
    pdev = PDevice(pdram.Geometry())
    jt, jm = getattr(jtraces, gen)(16384, jdram.Geometry(), mode=mode,
                                   device=jdev, setting=setting)
    pt, pm = getattr(ptraces, gen)(16384, pdram.Geometry(), mode=mode,
                                   device=pdev, setting=setting)
    assert jm == pm
    same_trace(jt, pt)


def test_pointer_chase_byte_identical():
    for nb in (1 << 16, 1 << 21):
        j = jtraces.pointer_chase(nb, jdram.Geometry(), n_loads=300, seed=2)
        p = ptraces.pointer_chase(nb, pdram.Geometry(), n_loads=300, seed=2)
        if j is None:
            assert p is None
            continue
        assert j[1:] == p[1:]
        same_trace(j[0], p[0])


def program_pool(seed=5, n_random=12):
    rng = np.random.RandomState(seed)
    progs = list(jsmc.builtin_programs().values()) \
        + list(jsmc.mitigation_programs().values())
    progs += [random_program(rng, max_ops=int(rng.choice([8, 16])),
                             name=f"r{i}") for i in range(n_random)]
    return progs


def test_program_digests_and_packing_identical():
    progs = program_pool()
    ported = [port_prog(p) for p in progs]
    for j, p in zip(progs, ported):
        assert j.digest == p.digest
        assert j.smc_cycles() == p.smc_cycles()
        assert j.describe() == p.describe()
        assert jsmc.table_bucket(j.n_ops) == psmc.table_bucket(p.n_ops)
        assert jsmc.pack_program(j).tobytes() == psmc.pack_program(p).tobytes()
    for bucket in (None, 16, 32):
        assert jsmc.pack_stack(progs, bucket).tobytes() == \
            psmc.pack_stack(ported, bucket).tobytes()
    jb = list(jsmc.builtin_programs().values())
    pb = list(psmc.builtin_programs().values())
    assert [p.digest for p in jb] == [p.digest for p in pb]
    assert [p.digest for p in jsmc.mitigation_programs().values()] == \
        [p.digest for p in psmc.mitigation_programs().values()]


def test_program_validation_matches():
    bad = [((99, 0, 0, 0),), ((psmc.OP_ADD, 0, 0, 0),),
           ((psmc.OP_CONST, 0, 0, 2 ** 31),)]
    for table in bad:
        with pytest.raises(ValueError):
            jsmc.PolicyProgram(table, score_reg=0).validate()
        with pytest.raises(ValueError):
            psmc.PolicyProgram(table, score_reg=0).validate()
    b = psmc.PolicyBuilder()
    with pytest.raises(ValueError, match="not a register"):
        psmc.PolicyBuilder().build(score=b.score_age())


@pytest.mark.parametrize("window", [1, 4, 8])
def test_emulator_state_init_and_host_roundtrip(window):
    jsys = dataclasses.replace(jts.JETSON_NANO, window=window)
    jh = JState.init(40, jsys).to_host()
    ph = PState.init(40, port_sys(jsys)).to_host()
    assert jh.keys() == ph.keys()
    for k in jh:
        if k == "bank":
            for kk in jh[k]:
                np.testing.assert_array_equal(jh[k][kk], ph[k][kk])
        elif k != "faults":
            np.testing.assert_array_equal(jh[k], ph[k], err_msg=k)
    back = PState.from_host(jh).to_host()
    for k in ("t_issue", "t_resp", "queue", "ptr", "last_bank"):
        np.testing.assert_array_equal(back[k], jh[k])
