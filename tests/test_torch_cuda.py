"""Each CUDA kernel of the port against its plain PyTorch version on the
card: exactly for the integer kernels and the copy, within the stated
tolerance for flash attention. Marked ``cuda``: they skip without a CUDA device. This
file imports no JAX, so it also runs on a GPU machine that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import (bloom as bloom_mod, emulator, executor,
                              faults, smcprog, techniques, timescale, traces)
from repro_torch.core.bloom import BloomFilter, words_tensor
from repro_torch.core.faults import FAULT_LOGS, FAULT_SCALARS, FaultModel
from repro_torch.core.timescale import JETSON_NANO
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.policy_vm import FAST_TABLE as VM_FAST_TABLE
from repro_torch.kernels.policy_vm import policy_vm_cuda
from repro_torch.kernels.ref_scan import ref_scan_cuda
from repro_torch.kernels.rowclone_copy import rowclone_copy_cuda
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.kernels.slot_scan import (FAST_BANKS, FAST_Q, FAST_TABLE,
                                           RESP_RING, ScanParams,
                                           instantiation, slot_scan_cuda,
                                           variant)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the card cases, shared with chip_smoke.py)

BLOOM_GRID = [(1 << 14, 2, 100), (1 << 16, 4, 5000), (1 << 18, 6, 20000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def bloom_case(m_bits, k, n):
    keys_in = np.arange(0, n * 3, 3, dtype=np.uint32)
    bf = BloomFilter.build(keys_in, m_bits=m_bits, k=k)
    probes = np.arange(0, n * 4, dtype=np.uint32)
    return bf, keys_in, probes


def vm_inputs(bucket, seed=0, q=16):
    rng = np.random.RandomState(seed)
    progs = [p for p in list(smcprog.builtin_programs().values())
             + list(smcprog.mitigation_programs().values())
             if smcprog.table_bucket(p.n_ops) <= bucket]
    tables = smcprog.pack_stack(progs, bucket)
    env = rng.randint(-2 ** 31, 2 ** 31, (smcprog.N_LOADS, q))
    return tables, env.astype(np.int32)


def long_program(n_ops, name="long"):
    """A fault-free program of at most ``n_ops`` ops whose score chains
    age, age_rel and constants through every row, with a row-hit boost."""
    b = smcprog.PolicyBuilder()
    v = b.score_age()
    hit = b.score_row_hit()
    for _ in range((n_ops - 2) // 4):
        v = b.add(v, b.min_(b.age_rel(), b.const(7)))
    return b.build(score=v, boost=hit, name=name)


def scan_params(batch, n):
    return ScanParams(batch=batch, n=n, window=4, q=4, slots=200, n_banks=16,
                      n_rows=32768, scale_num=4879, mc_lat=29, mc_issue_ts=3,
                      nots=0, frfcfs=1, table_len=0, use_weak=0, tRCD=17,
                      tRCD_reduced=11, tCL=17, tRP=17, tRAS=39, tWR=18, tBL=4,
                      tRFC=420, tREFI=9360, tRC_CLONE=90)


@pytest.mark.cuda
@pytest.mark.parametrize("m_bits,k,n", BLOOM_GRID)
def test_bloom_probe_kernel_matches_plain(cuda_device, m_bits, k, n):
    bf, keys_in, probes = bloom_case(m_bits, k, n)
    words = words_tensor(bf.bits, cuda_device)[None]
    keys = torch.from_numpy(probes.view(np.int32)).to(cuda_device)[None]
    got = ops.bloom_probe(words, keys, k, m_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.bloom_probe_ref(words, keys, k, m_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m_bits,k,per_row", chip_smoke.BLOOM_CASES)
def test_bloom_probe_cases_match_plain(cuda_device, B, n, m_bits, k,
                                       per_row):
    from repro_torch.kernels.bloom_probe import bloom_probe_cuda
    words, keys = (torch.from_numpy(a).to(cuda_device) for a in
                   chip_smoke.bloom_case(np, B, n, m_bits, k, per_row))
    want = ref.bloom_probe_ref(words, keys, k, m_bits)
    assert 0 < int(want.sum()) or B * n < 100
    # the same keys one int past a 16-byte boundary: the wrapper realigns
    buf = torch.empty(B * n + 1, dtype=torch.int32, device=cuda_device)
    buf[1:] = keys.flatten()
    for kk in (keys, buf[1:].view(B, n)):
        ops.reset_launches()
        got = bloom_probe_cuda(words, kk, k, m_bits)
        torch.cuda.synchronize()
        assert ops.launches()["bloom_probe"] == 1
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_stream_handle_is_the_current_stream(cuda_device):
    """The raw handle the wrappers launch on is the current stream's,
    inside a side stream's context too, with or without a device index."""
    assert ops.stream_handle(cuda_device) == \
        torch.cuda.current_stream(cuda_device).cuda_stream
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        for dev in (cuda_device, torch.device("cuda",
                                               torch.cuda.current_device())):
            assert ops.stream_handle(dev) == side.cuda_stream


# every bucket from 8 to 1024, the fast instantiation up to 256 rows (1,
# 2 and 4 warps: 80 and 200 lanes) and the wide one past it; random
# valid programs beside garbage tables, environment values that overflow
@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [8, 16, 32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("q", [1, 80, 200])
def test_policy_vm_kernel_every_bucket(cuda_device, bucket, q):
    rng = np.random.RandomState(bucket + q)
    tables, env = vm_inputs(min(bucket, 16), q=q)
    tables = np.concatenate([
        smcprog.pack_stack([long_program(bucket - 3)]
                           + list(smcprog.builtin_programs().values()),
                           bucket),
        chip_smoke.garbage_tables(np, rng, 24, bucket)])
    t = torch.from_numpy(tables).to(cuda_device)
    e = torch.from_numpy(env).to(cuda_device)
    ops.reset_launches()
    got = policy_vm_cuda(t, e)
    torch.cuda.synchronize()
    assert ops.launches()["policy_vm"] == 1
    assert torch.equal(got.cpu(), ref.policy_vm_ref(t.cpu(), e.cpu()))


# buckets of the fast instantiation, and of the wide one with its values
# in shared memory (512) and in global scratch (2048: 32 x 2048 ints are
# more than 227 KB)
@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [8, 16, 512, 2048])
def test_policy_vm_kernel_matches_plain(cuda_device, bucket):
    tables, env = vm_inputs(bucket, q=80)
    if bucket > VM_FAST_TABLE:
        tables = np.concatenate([smcprog.pack_stack(
            [long_program(bucket - 3)], bucket), tables])
    t = torch.from_numpy(tables).to(cuda_device)
    e = torch.from_numpy(env).to(cuda_device)
    ops.reset_launches()
    got = policy_vm_cuda(t, e)
    torch.cuda.synchronize()
    want = "fast" if bucket <= VM_FAST_TABLE else \
        "wide-shared" if bucket < 2048 else "wide-global"
    assert ops.variants() == {f"policy_vm/{want}": 1}
    assert torch.equal(got, ref.policy_vm_ref(t, e))


# Each case varies the base group (4 rows x 64 requests, window 4, 16
# banks, FR-FCFS, 200 slots) where the warp kernel's design could break
# exactness: a 2-lane, a 4-lane and a 64-lane queue (two lanes per
# thread); 64 banks; traces longer than the on-chip t_resp ring with
# dependences reaching past it (served from global memory); an all-NOP
# filler row; rows that drain long before a surplus slot budget ends;
# a budget that ends mid-trace (the trailing pass resolves NOPs whose
# t_resp later advances read); divisors off the defaults (frequent
# refreshes, a time-scaling denominator below 4096); the largest policy
# table.
SCAN_CASES = {
    "legacy": {},
    "table-and-weak": {"table": 8, "weak": True, "nots": 1},
    "window1-q2": {"window": 1},
    "window64-q64": {"window": 64, "n": 256, "slots": 600},
    "window64-table": {"window": 64, "n": 256, "slots": 600, "table": 8,
                       "weak": True, "nots": 1},
    "banks64": {"banks": 64},
    "ring-and-far-deps": {"B": 2, "n": RESP_RING + 512,
                          "far_deps": RESP_RING,
                          "slots": 2 * (RESP_RING + 512) + 8},
    "nop-filler-row": {"nop_rows": (1,)},
    "drain-early": {"real": 8, "slots": 1000},
    "budget-ends-mid-trace": {"slots": 40},
    "odd-divisors": {"params": {"tREFI": 97, "scale_num": 3001,
                                "tRFC": 41}},
    "table256": {"B": 2, "n": 32, "slots": 80, "table": 256, "nots": 1},
    # issue times past BIG (2^30) and past int32 (wrapping): the general
    # argmin, a free lane winning, and age_rel's base with a table
    "keys-past-big-table": {"delta_scale": 1 << 24, "table": 8, "nots": 1},
    "keys-past-big": {"delta_scale": 1 << 24},
}

# The fault path (faults=1): the fast instantiation's legacy and policy
# variants (frfcfs, PARA and TRR rows) with both processes; each process
# alone; a one-entry victim log under a flip on every activation and READ
# (the log overflows, the counts go on); a hammer threshold of 2 with a
# REF every 61 ticks (crossings on the slots of all-bank REFs, whose reset
# comes first); PARA without a fault model (seed 0, no fault outputs); the
# wide instantiation (window 80, 128 banks) with faults, legacy and
# policy; issue times past BIG (2^30) with faults, legacy (a free lane
# may win and request 0 is served, its weak-cell flag drawn there) and
# with mitigation programs that fire on every decision they can (PARA
# always, TRR from a count of 1), since few decisions come before BIG.
CARD_FM = dict(seed=3, hammer_threshold=8, hammer_flip_fp=30000,
               weak_fp=16000, retention_ticks=30, victim_slots=16)
TUNED = dict(para_fp=3277, trr_threshold=4)
FAULT_CASES = {
    "faults-legacy": {"fault": {}},
    "faults-policy": {"fault": {"hammer_threshold": 3}, "table": 8,
                      "mitigation": True, "B": 6, "nots": 1},
    "faults-hammer-only": {"fault": {"weak_fp": 0, "hammer_threshold": 3}},
    "faults-retention-only": {"fault": {"hammer_threshold": 0}},
    "faults-log-overflow": {"fault": {
        "victim_slots": 1, "hammer_threshold": 1, "hammer_flip_fp": 65536,
        "weak_fp": 65536, "retention_ticks": 0}},
    "faults-crossing-on-ref": {"fault": {"hammer_threshold": 2},
                               "table": 8, "mitigation": True, "B": 6,
                               "params": {"tREFI": 61, "tRFC": 41}},
    "para-no-fault-model": {"table": 8, "mitigation": True, "B": 6,
                            "nots": 1},
    "faults-wide-q80": {"fault": {}, "window": 80, "n": 256, "slots": 600},
    "faults-wide-banks128-policy": {"fault": {"hammer_threshold": 3},
                                    "banks": 128, "n": 256,
                                    "slots": 600, "table": 8,
                                    "mitigation": True, "B": 6, "nots": 1},
    "faults-keys-past-big": {"fault": {}, "B": 6, "delta_scale": 1 << 24},
    "faults-keys-past-big-table": {"fault": {}, "table": 8, "B": 6,
                                   "mitigation": {"para_fp": 65536,
                                                  "trr_threshold": 1},
                                   "delta_scale": 1 << 24},
}

# The shapes past the fast instantiation, which the reference runs too:
# a queue just past it (65) and well past (100); windows at the fast
# ring's size (1016: a full 1016-lane queue in a 1024-entry ring) and past
# it (1100: a 2048-entry ring), with no near dependences (the queue fills)
# and a tenth of the requests depending on one past the ring; banks
# just past (65), 128, 4096, and 20000 (a row's state above 227 KB, in
# global scratch); tables just past (257 rows), 512 and 1024 with a long
# program among the built-ins; keys past BIG with a table.
WIDE_CASES = {
    "q65": {"window": FAST_Q + 1, "n": 256, "slots": 600},
    "q100": {"window": 100, "n": 256, "slots": 600, "weak": True},
    "window1016-ring": {"B": 2, "window": 1016, "n": 2048, "slots": 4104,
                        "dep_max": 1, "far_deps": RESP_RING},
    "window1100-past-ring": {"B": 2, "window": 1100, "n": 3072,
                             "slots": 6152, "dep_max": 1, "far_deps": 2048},
    "banks65": {"banks": FAST_BANKS + 1},
    "banks128": {"banks": 128, "n": 256, "slots": 600},
    "banks4096": {"banks": 4096, "n": 256, "slots": 600},
    "banks20000-global": {"B": 2, "banks": 20000, "n": 256, "slots": 600},
    "table257": {"B": 2, "n": 32, "slots": 80, "table": FAST_TABLE + 1,
                 "nots": 1},
    "table512": {"B": 2, "n": 48, "slots": 110, "table": 512, "nots": 1},
    "table1024-q80": {"B": 2, "n": 32, "slots": 80, "table": 1024,
                      "window": 80, "weak": True, "nots": 1},
    "keys-past-big-table-q80": {"delta_scale": 1 << 24, "table": 8,
                                "window": 80, "nots": 1},
}


def scan_case(dev, B=4, n=64, window=4, banks=16, slots=200, table=0,
              weak=False, nots=0, far_deps=0, nop_rows=(), real=None,
              params=None, delta_scale=1, dep_max=3, fault=None,
              mitigation=False):
    """Seeded inputs of one slot-scan group; the queue has
    ``max(window, 2)`` lanes, as the engine sizes it. ``fault``: the
    fault model's fields over ``CARD_FM`` (None: none); ``mitigation``:
    the tables cycle the tuned mitigation programs (frfcfs, PARA, TRR), or
    those of the given ``mitigation_programs`` settings."""
    rng = np.random.RandomState(0)
    kind, bank, row, delta, dep = (
        rng.randint(0, 5, (B, n)), rng.randint(0, banks, (B, n)),
        rng.randint(0, 64, (B, n)), rng.randint(0, 24, (B, n)),
        rng.randint(0, dep_max, (B, n)))
    delta = delta * delta_scale
    if far_deps:   # some requests wait on one issued more than far_deps ago
        far = rng.random_sample((B, n)) < 0.1
        dep[far] = rng.randint(far_deps + 1, far_deps + 256, int(far.sum()))
    if real is not None:   # row 0: `real` requests, then NOP padding
        kind[0, real:] = 4
    for r in nop_rows:
        kind[r] = 4
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (kind, bank, row, delta, dep)]
    costs = torch.tensor([[520, 260]] * B, dtype=torch.int32, device=dev)
    p = dataclasses.replace(scan_params(B, n), window=window,
                            q=max(window, 2), n_banks=banks, slots=slots,
                            nots=nots, **(params or {}))
    w = tables = None
    if weak:
        w = torch.from_numpy(rng.randint(0, 2, (B, n)).astype(np.int8)).to(dev)
        p = dataclasses.replace(p, use_weak=1)
    progs = []
    if table:
        progs = list(smcprog.builtin_programs().values())
        if mitigation:
            progs = list(smcprog.mitigation_programs(
                **(TUNED if mitigation is True else mitigation)).values())
        if table > FAST_TABLE:
            progs = [long_program(table // 2 + 8)] + progs
        progs = [progs[i % len(progs)] for i in range(B)]
        tables = torch.from_numpy(smcprog.pack_stack(progs, table)).to(dev)
        p = dataclasses.replace(p, table_len=table)
    fm = None if fault is None else FaultModel(**{**CARD_FM, **fault})
    para = any(q.uses(smcprog.OP_PARA_RAND) for q in progs)
    p = dataclasses.replace(p, **emulator._fault_params(
        JETSON_NANO.with_faults(fm), para))
    return args, w, tables, costs, p


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(SCAN_CASES) + list(WIDE_CASES))
def test_slot_scan_kernel_matches_plain(cuda_device, variant):
    case = SCAN_CASES[variant] if variant in SCAN_CASES \
        else WIDE_CASES[variant]
    args, weak, tables, costs, p = scan_case(cuda_device, **case)
    ops.reset_launches()
    got = ops.slot_scan(*args, weak, tables, costs, p)
    torch.cuda.synchronize()
    assert ops.launches()["slot_scan"] == 1
    kind = instantiation(p)
    assert kind == ("wide" if variant in WIDE_CASES else "fast")
    if kind == "wide":
        kind += "-global" if variant.endswith("-global") else "-shared"
    assert ops.variants() == {f"slot_scan/{kind}": 1}
    # the plain version on CPU copies of the same inputs (it is launch-bound
    # on the card)
    cpu = [None if t is None else t.cpu()
           for t in (*args, weak, tables, costs)]
    want = ref.slot_scan_ref(*cpu, p)
    for f in want:
        assert torch.equal(got[f].cpu(), want[f]), f
    if variant == "drain-early":   # the budget outlasts every row
        assert int(want["served"].sum()) == int((args[0] != 4).sum())


def ref_decided_activations(monkeypatch):
    """Count, per slot of the plain engine's next run, the activations
    served on the slot of an all-bank REF whose bank counter would reach
    the hammer threshold if the REF's reset did not come first (the order
    decides whether they cross); returns the list it fills."""
    seen = []
    real = ref.apply_slot

    def spy(fm, n_rows, tREFI, mit_ticks, fstate, **kw):
        stale = torch.gather(fstate["hct"], 1,
                             kw["bank"].long().unsqueeze(1)).squeeze(1) + 1
        seen.append(int((kw["do"] & ~kw["hit"] & kw["refreshed"]
                         & (stale >= fm.hammer_threshold)).sum()))
        return real(fm, n_rows, tREFI, mit_ticks, fstate, **kw)

    monkeypatch.setattr(ref, "apply_slot", spy)
    return seen


def para_score_case(dev, banks):
    """A policy group whose first program scores by para_rand (the draws
    order the service) beside one scoring by a constant 0, and the same
    group's scalars on (faults=1) and off (faults=0) the fault path."""
    args, _, _, costs, p = scan_case(dev, banks=banks, n=128, slots=300,
                                     table=8, nots=1)
    progs = []
    for score in ("para_rand", "zero"):
        b = smcprog.PolicyBuilder()
        v = b.para_rand() if score == "para_rand" else b.const(0)
        progs.append(b.build(score=v, boost=b.score_row_hit(), name=score))
    progs = [progs[i % 2] for i in range(p.batch)]
    tables = torch.from_numpy(smcprog.pack_stack(progs, 8)).to(dev)
    on = dataclasses.replace(p, **emulator._fault_params(JETSON_NANO, True))
    return args, tables, costs, on, dataclasses.replace(on, faults=0)


@pytest.mark.cuda
@pytest.mark.parametrize("banks", [16, 128])
def test_slot_scan_para_rand_on_and_off_the_fault_path(cuda_device, banks):
    """``ScanParams.faults`` decides whether para_rand is drawn, alike in
    the fast and the wide instantiation and in the plain engine: on the
    fault path the kernel draws as the plain engine does, off it both load
    0 (the engine never runs such a table off it)."""
    args, tables, costs, on, off = para_score_case(cuda_device, banks)
    cpu = [t.cpu() for t in (*args, tables, costs)]
    outs = {}
    for name, p in (("on", on), ("off", off)):
        ops.reset_launches()
        got = ops.slot_scan(*args, None, tables, costs, p)
        torch.cuda.synchronize()
        assert ops.variants() == {f"slot_scan/{variant(p)}": 1}
        want = ref.slot_scan_ref(*cpu[:5], None, *cpu[5:], p)
        assert set(got) == set(want)
        for f in want:
            assert torch.equal(got[f].cpu(), want[f]), (name, f)
        outs[name] = want
    assert not torch.equal(outs["on"]["t_resp"], outs["off"]["t_resp"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_slot_scan_fault_path_matches_plain(cuda_device, case, monkeypatch):
    """Every output field, the fault fields included, equal to the plain
    engine's; the variant that ran is the fault path's."""
    c = FAULT_CASES[case]
    args, weak, tables, costs, p = scan_case(cuda_device, **c)
    assert p.faults == 1
    ops.reset_launches()
    got = ops.slot_scan(*args, weak, tables, costs, p)
    torch.cuda.synchronize()
    assert ops.variants() == {f"slot_scan/{variant(p)}": 1}
    assert variant(p).startswith("wide" if "wide" in case else "fast-faults")
    cpu = [None if t is None else t.cpu()
           for t in (*args, weak, tables, costs)]
    ref_first = []
    if case == "faults-crossing-on-ref":
        ref_first = ref_decided_activations(monkeypatch)
    want = ref.slot_scan_ref(*cpu, p)
    assert set(got) == set(want)
    for f in want:
        assert torch.equal(got[f].cpu(), want[f]), f
    if "fault" not in c:
        assert not set(FAULT_SCALARS) & set(got)
        return
    assert set(FAULT_SCALARS + FAULT_LOGS) <= set(got)
    if case == "faults-crossing-on-ref":
        # the case occurs: activations on the slot of an all-bank REF
        # whose counter would have crossed but for the REF's reset first
        assert sum(ref_first) > 0
    else:
        assert int(want["flips"].sum()) > 0
    if case == "faults-log-overflow":
        assert int(want["flips"].min()) > 1
    if c.get("mitigation"):
        assert int(want["mitigations"].sum()) > 0


@pytest.mark.cuda
def test_fault_entry_points_on_the_card(cuda_device):
    """The RowHammer study (both policy axes) and a wide fault group
    through the entry points with the default device (CUDA), against the
    same calls on the CPU; every launch took the fault path."""
    fm = FaultModel(**CARD_FM)
    study = techniques.RowHammerMitigationStudy(JETSON_NANO, fault_model=fm)
    for axis in (True, False):
        ops.reset_launches()
        got = study.evaluate(n_requests=200, policy_axis=axis)
        variants = ops.variants()
        assert set(variants) == {"slot_scan/fast-faults"}, variants
        assert got == study.evaluate(n_requests=200, policy_axis=axis,
                                     device="cpu")
    sys_ = dataclasses.replace(JETSON_NANO, window=80).with_faults(fm)
    tr = traces.rowhammer_trace(300, sys_.geometry, intensity=0.6, seed=2)
    ops.reset_launches()
    got = emulator.run_many([tr, tr], sys_)
    assert set(ops.variants()) == {"slot_scan/wide-shared"}
    want = emulator.run_many([tr, tr], sys_, device="cpu")
    for a, b in zip(got, want):
        assert int(a["flips"]) > 0
        for f in ("exec_cycles", "served", "t_resp") + FAULT_SCALARS \
                + FAULT_LOGS + ("bit_error_rate",):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


# The stream path's window entry on the card: chip_smoke.py's stream cuts
# (WINDOW_CASES) at a smaller size, every window of the kernel against the
# plain window step on CPU copies of its inputs, on every state field.
CARD_WINDOW = dict(n=800, chunk=128)
STREAM_FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
                 "smc_fpga_cycles", "avg_load_latency_cycles")


def record_windows(monkeypatch):
    """Route ``ops.slot_scan_window`` through a spy that keeps each call's
    inputs and the state the kernel returned."""
    calls = []
    kernel = ops.slot_scan_window

    def spy(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(ops, "slot_scan_window", spy)
    return calls


def assert_stream_equals_single_shot(got, want, n):
    for f in STREAM_FIELDS:
        assert float(got[f]) == float(want[f]), f
    for f in ("t_resp", "t_issue"):
        np.testing.assert_array_equal(got[f], want[f][:n], err_msg=f)
    if "flips" in want:
        for f in FAULT_SCALARS + FAULT_LOGS + ("bit_error_rate",):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(chip_smoke.WINDOW_CASES))
def test_slot_scan_window_kernel_matches_plain_step(cuda_device, case,
                                                    monkeypatch):
    """Each window's kernel state equals the plain window step's on every
    field (the legacy scheduler, the policy VM, the fault kernel, PARA
    without a fault model, Bloom filters, the wide instantiation, a chunk
    equal to the halo, rows that drain in an interior window); the stream
    equals single-shot ``run_many`` on the card."""
    sys_, trs, kw, chunk = chip_smoke.window_case(
        np, emulator, smcprog, timescale, traces, faults, case, **CARD_WINDOW)
    calls = record_windows(monkeypatch)
    ops.reset_launches()
    got = emulator.run_stream_many(trs, sys_, chunk=chunk, **kw)
    torch.cuda.synchronize()
    launches, variants = ops.launches(), ops.variants()
    assert launches["slot_scan_window"] == len(calls) > 1
    assert launches["slot_scan"] == 0
    p = calls[0][0][-2]
    assert p.slots == emulator.stream_slot_budget(chunk, sys_)
    c = chip_smoke.WINDOW_CASES[case]
    fault_path = bool(c.get("fault")) or c.get("tables") == "mitigation"
    assert variant(p) == ("wide-shared" if "wide" in case else
                          "fast-faults" if fault_path else "fast")
    assert variants == {f"slot_scan_window/{variant(p)}": len(calls)}
    if "bloom" in kw:
        assert launches["bloom_probe"] == len(calls)
    err = chip_smoke.window_errors(ref, calls)
    assert not any(err.values()), err
    for tr, a, b in zip(trs, got, emulator.run_many(trs, sys_, **kw)):
        assert_stream_equals_single_shot(a, b, tr.n)
    if case == "chunk-equals-halo":
        assert chunk == emulator.stream_halo(sys_)
    if case == "drain-in-interior-window":
        # a row served its whole stream and emptied its queue in a window
        # that was not the last
        served = [int(r["served"]) for r in got]
        assert any(
            bool((out.queue[j] < 0).all()) and int(out.served_n[j]) == sv
            and sv > 0 and k < len(calls) - 1
            for k, (_, out) in enumerate(calls)
            for j, sv in enumerate(served))
    if chip_smoke.WINDOW_CASES[case].get("fault"):
        assert sum(int(r["flips"]) for r in got) > 0


@pytest.mark.cuda
def test_run_stream_on_the_card_equals_run(cuda_device):
    """``run_stream`` with the default device (CUDA) against ``run`` on
    the card and ``run_stream`` on the CPU; nothing falls back."""
    tr = chip_smoke.materialize(np, emulator, traces.synthetic_stream(
        700, window=300, seed=2, kinds=5))
    ops.reset_launches()
    got = emulator.run_stream(traces.iter_windows(tr, 99), JETSON_NANO,
                              chunk=64)
    assert ops.launches()["slot_scan_window"] > 1
    assert_stream_equals_single_shot(got, emulator.run(tr, JETSON_NANO),
                                     tr.n)
    cpu = emulator.run_stream(tr, JETSON_NANO, chunk=64, device="cpu")
    for f in ("t_resp", "t_issue"):
        np.testing.assert_array_equal(got[f], cpu[f])


class UncheckedProgram(smcprog.PolicyProgram):
    """A program whose registers may point past its rows (``validate``
    refuses that; the reference VM clips and reads the padding)."""

    def validate(self):
        return self


@pytest.mark.cuda
def test_run_policies_score_in_padding_row(cuda_device):
    """The score register of one program points into its table's padding
    (a constant 0 row: every score ties), the boost at a row hit; beside
    a built-in. The kernel's decode must read the padding row as the
    reference does."""
    b = smcprog.PolicyBuilder()
    b.score_age()
    hit = b.score_row_hit()
    b.and_(hit, b.not_(b.mask_bank_busy()))
    prog = UncheckedProgram(tuple(b._rows), score_reg=6, boost_reg=1,
                            mitigate_reg=-1, name="score-in-padding")
    progs = [prog, smcprog.frfcfs_program()]
    rng = np.random.RandomState(5)
    n = 300
    trace = interop.trace_from_arrays(
        kind=rng.randint(0, 5, n), bank=rng.randint(0, 16, n),
        row=rng.randint(0, 8, n), delta=rng.randint(0, 6, n),
        dep=rng.randint(0, 3, n))
    sys_ = dataclasses.replace(JETSON_NANO, window=40)
    got = emulator.run_policies(trace, sys_, progs, mode="nots")
    want = emulator.run_policies(trace, sys_, progs, mode="nots",
                                 device="cpu")
    for a, w in zip(got, want):
        assert int(a["served"]) == a["n_requests"] > 0
        for f in ("exec_cycles", "row_hits", "served", "dram_ticks",
                  "smc_fpga_cycles", "t_resp", "t_issue"):
            np.testing.assert_array_equal(a[f], w[f], err_msg=f)


# only configurations the reference cannot run either are refused: a
# queue, bank count or table past the fast instantiation runs in the wide
# one (WIDE_CASES above)
@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [("q", 1), ("n_banks", 0),
                                         ("table_len", -1), ("tREFI", 0),
                                         ("window", 5)])
def test_slot_scan_cuda_refuses_past_its_limits(cuda_device, field, value):
    args, weak, tables, costs, p = scan_case(cuda_device)
    ops.reset_launches()
    with pytest.raises(ValueError, match="invalid configuration"):
        slot_scan_cuda(*args, weak, tables, costs,
                       dataclasses.replace(p, **{field: value}))
    assert ops.launches()["slot_scan"] == 0


# Through the engine's entry points with the default device (CUDA), each
# shape the fast instantiation does not take, against the plain engine on
# the CPU: queues 65, 100, 1016 and 1100 (windows; no dependences, so
# that the queue fills), banks 65, 128 and 4096 (drawn over all of them),
# policy tables 512 and 1024 (a program of more than 256 or 512 ops beside
# a built-in, through run_policies).
ENGINE_SHAPES = {
    "q65": {"window": 65, "n": 200, "dep_max": 1},
    "q100": {"window": 100, "n": 200},
    "q1016": {"window": 1016, "n": 1300, "dep_max": 1},
    "q1100": {"window": 1100, "n": 1300, "dep_max": 1},
    "banks65": {"n_banks": 65, "n": 200},
    "banks128": {"n_banks": 128, "n": 200},
    "banks4096": {"n_banks": 4096, "n": 200},
    "table512": {"n_ops": 300, "n": 40},
    "table1024": {"n_ops": 600, "n": 24},
}


def engine_case(shape):
    """A seeded trace, a config and (for a table) programs of one shape."""
    c = ENGINE_SHAPES[shape]
    n_banks = c.get("n_banks", 16)
    sys_ = dataclasses.replace(
        JETSON_NANO, window=c.get("window", JETSON_NANO.window),
        geometry=dataclasses.replace(JETSON_NANO.geometry, n_banks=n_banks))
    rng = np.random.RandomState(sorted(ENGINE_SHAPES).index(shape))
    n = c["n"]
    trace = interop.trace_from_arrays(
        kind=rng.randint(0, 5, n), bank=rng.randint(0, n_banks, n),
        row=rng.randint(0, 64, n), delta=rng.randint(0, 6, n),
        dep=rng.randint(0, c.get("dep_max", 3), n))
    progs = None
    if "n_ops" in c:
        progs = [long_program(c["n_ops"]), smcprog.fcfs_program()]
    return sys_, trace, progs


def engine_run(sys_, trace, progs, device=None):
    if progs is not None:
        return emulator.run_policies(trace, sys_, progs, mode="nots",
                                     device=device)
    return [emulator.run(trace, sys_, m, device=device)
            for m in ("ts", "nots")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(ENGINE_SHAPES))
def test_engine_runs_every_reference_shape_on_the_card(cuda_device, shape):
    sys_, trace, progs = engine_case(shape)
    ops.reset_launches()
    got = engine_run(sys_, trace, progs)
    torch.cuda.synchronize()
    # a built-in beside the long program runs in the fast instantiation
    wide = {k: n for k, n in ops.variants().items() if "/wide" in k}
    assert sum(wide.values()) == (1 if progs else 2), ops.variants()
    want = engine_run(sys_, trace, progs, device="cpu")
    for a, b in zip(got, want):
        assert int(a["served"]) == a["n_requests"] > 0
        for f in ("exec_cycles", "row_hits", "served", "dram_ticks",
                  "smc_fpga_cycles", "t_resp", "t_issue"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def engine_tasks(sys_, trace, progs, results, device=None):
    """The groups of :func:`engine_run` as executor tasks, unlaunched."""
    if progs is not None:
        return emulator.prepare_tasks(
            [trace] * len(progs), sys_, "nots", None, results,
            policies=progs, policy_costs=[p.smc_cycles() for p in progs],
            device=device)
    return emulator.prepare_tasks([trace, trace], sys_, ["ts", "nots"],
                                  None, results, device=device)


@pytest.mark.cuda
def test_overlapped_wide_groups_of_different_layouts(cuda_device):
    """Wide groups whose shared-memory regions differ in size (queues,
    banks, tables) overlapped on the executor's streams in one call:
    each launch's dynamic shared memory holds whatever the others set,
    and every group equals the plain engine."""
    shapes = ["q65", "q1016", "banks128", "banks4096", "table512",
              "table1024"]
    results, tasks = {}, []
    for shape in shapes:
        sys_, trace, progs = engine_case(shape)
        results[shape] = [None] * (len(progs) if progs else 2)
        tasks += engine_tasks(sys_, trace, progs, results[shape])
    ops.reset_launches()
    assert executor.execute(tasks, serial=False) == []
    torch.cuda.synchronize()
    assert ops.launches()["slot_scan"] == len(tasks) > len(shapes)
    for shape in shapes:
        want = engine_run(*engine_case(shape), device="cpu")
        for a, b in zip(results[shape], want):
            for f in ("exec_cycles", "row_hits", "served", "dram_ticks",
                      "smc_fpga_cycles", "t_resp", "t_issue"):
                np.testing.assert_array_equal(a[f], b[f],
                                              err_msg=f"{shape} {f}")


def service_points():
    """A small grid: ts, nots, a Bloom filter, a fault model, a staged and
    a runtime policy, over seeded bucket-64 traces."""
    from repro_torch.core.campaign import Point
    rng = np.random.RandomState(5)
    trs = [interop.trace_from_arrays(
        kind=rng.randint(0, 5, n), bank=rng.randint(0, 16, n),
        row=rng.randint(0, 256, n), delta=rng.randint(0, 24, n),
        dep=rng.randint(0, 3, n)) for n in (40, 52, 60)]
    bf = BloomFilter.build(np.arange(0, 4096, 3, dtype=np.uint32),
                           m_bits=1 << 14, k=3)
    bloom = (bf.bits, bf.k, bf.m_bits)
    fsys = JETSON_NANO.with_faults(FaultModel(**CARD_FM))
    ssys = JETSON_NANO.with_policy(smcprog.frfcfs_program())
    prog = smcprog.fcfs_program()
    pts = []
    for tr in trs:
        for sys_, mode, bl in ((JETSON_NANO, "ts", None),
                               (JETSON_NANO, "nots", None),
                               (JETSON_NANO, "reference", bloom),
                               (fsys, "ts", None), (ssys, "nots", None)):
            pts.append(Point(tr, sys_, mode, bl, {"idx": len(pts)}))
        pts.append(Point(tr, JETSON_NANO, "ts", None,
                         {"idx": len(pts), "policy": prog.name},
                         policy=prog, policy_cost=prog.smc_cycles()))
    return pts


@pytest.mark.cuda
def test_sweep_service_on_the_card_equals_serial_campaign(cuda_device):
    """Three clients through the service on the card (the default
    device): their records equal the port's serial ``Campaign.run`` on
    the card and on the CPU (the plain engine), and the service's
    dispatches launched ``slot_scan`` and ``bloom_probe``."""
    from repro_torch.core.campaign import Campaign
    from repro_torch.service import SweepClient, SweepServer
    pts = service_points()
    camp = Campaign()
    camp.points = pts
    card = camp.run(serial=True)
    plain = camp.run(serial=True, device="cpu")
    ops.reset_launches()
    with SweepServer(coalesce_window_s=0.25) as srv:
        clis = [SweepClient(server=srv, name=f"c{k}") for k in range(3)]
        for p in pts:   # one trace a client: 3 clients in every group
            clis[p.meta["idx"] // 6].submit_points([p])
        got = {}
        for cli in clis:
            got.update((r["idx"], r) for r in cli.collect(timeout=300))
        st = srv.stats()
    counts = ops.launches()
    assert counts["slot_scan"] == st["dispatches"]["count"] == 6
    assert counts["bloom_probe"] >= 1 and st["coalesce_ratio"] == 3.0
    for want_card, want_plain in zip(card, plain):
        rec = got[want_card["idx"]]
        for f in ("exec_cycles", "row_hits", "served", "dram_ticks",
                  "smc_fpga_cycles", "t_resp", "t_issue"):
            np.testing.assert_array_equal(rec[f], want_card[f], err_msg=f)
            np.testing.assert_array_equal(rec[f], want_plain[f], err_msg=f)


# the grid and tolerances of tests/test_kernels.py: the kernel sums in
# another order than the plain softmax (online, in key tiles) and splits
# each product into three TF32 products (3xTF32)
FLASH_GRID = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 8, 8, 128),
              (1, 128, 4, 1, 256)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda_device, B, S, H, KV, hd,
                                              dtype, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(B * S + H)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=cuda_device).to(dtype)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == 1
    flat = [t.permute(0, 2, 1, 3).reshape(-1, S, hd) for t in (q, k, v)]
    want = (ref.flash_attention_ref(*flat, causal)
            .reshape(B, H, S, hd).permute(0, 2, 1, 3))
    assert got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the serving path's prefill layer (S = 1024, hd = 128, fp32, causal,
# four q heads over one kv head), and hd = 256 in bf16 over ragged tiles
FLASH_SERVING = [(1024, 4, 1, 128, torch.float32, True),
                 (320, 4, 2, 256, torch.bfloat16, True),
                 (320, 4, 2, 256, torch.bfloat16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,KV,hd,dtype,causal", FLASH_SERVING)
def test_flash_attention_kernel_at_serving_shapes(cuda_device, S, H, KV, hd,
                                                  dtype, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q = torch.randn((H, S, hd), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((KV, S, hd), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((KV, S, hd), generator=g, device=cuda_device).to(dtype)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_ragged_keys(cuda_device):
    """Non-causal with Sk not a multiple of the 64-key tile: the keys past
    the end get probability 0."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((4, 128, 128), generator=g, device=cuda_device)
    k = torch.randn((2, 100, 128), generator=g, device=cuda_device)
    v = torch.randn((2, 100, 128), generator=g, device=cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(flash_attention_cuda(q, k, v, causal=False),
                               ref.flash_attention_ref(q, k, v, False),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_flash_attention_cuda_refusals(cuda_device):
    kv = torch.zeros((2, 128, 64), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(torch.zeros((4, 128, 32), device=cuda_device),
                             kv[..., :32], kv[..., :32], causal=False)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_cuda(torch.zeros((4, 64, 64), device=cuda_device),
                             kv, kv, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(torch.zeros((4, 128, 64)), kv, kv, causal=True)


# the reference copy grid, the fork's shape class (36 rows written 4 row
# sizes apart, each row larger than one block's 32 KB chunk) and a large
# ragged copy (16-byte units and a tail when contiguous, the byte path
# into strided rows)
ROWCLONE_SHAPES = [(8, 128), (64, 512), (33, 257), (1, 8192), (36, 65664),
                   (3, 300007)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROWCLONE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_rowclone_copy_kernel_matches_plain(cuda_device, shape, dtype):
    x = torch.arange(int(np.prod(shape)), device=cuda_device).reshape(
        shape).to(dtype)
    ops.reset_launches()
    got = ops.rowclone_copy(x)
    assert torch.equal(got, ref.rowclone_copy_ref(x))
    # into slot 1 of a [R, 4, C] tensor (strided rows, as the 4-way fork
    # writes them), and from an unaligned base (a view one element in)
    wide = torch.zeros((shape[0], 4, shape[1]), dtype=dtype,
                       device=cuda_device)
    want = torch.zeros_like(wide)
    ops.rowclone_copy(x, out=wide[:, 1])
    ref.rowclone_copy_ref(x, out=want[:, 1])
    assert torch.equal(wide, want)
    flat = torch.arange(x.numel() + 1, device=cuda_device).to(dtype)
    odd = flat[1:].view(shape)
    assert torch.equal(rowclone_copy_cuda(odd), odd)
    torch.cuda.synchronize()
    assert ops.launches()["rowclone_copy"] == 3


@pytest.mark.cuda
def test_rowclone_copy_cuda_refuses_cpu_out(cuda_device):
    with pytest.raises(ValueError, match="CUDA"):
        rowclone_copy_cuda(torch.zeros((4, 8), device=cuda_device),
                           out=torch.zeros((4, 8)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ops.KERNELS)
def test_empty_input_launches_and_counts_nothing(cuda_device, name):
    ops.reset_launches()
    if name == "bloom_probe":
        bf, _, _ = bloom_case(1 << 14, 2, 100)
        words = words_tensor(bf.bits, cuda_device)[None]
        keys = torch.empty((1, 0), dtype=torch.int32, device=cuda_device)
        out = ops.bloom_probe(words, keys, 2, 1 << 14)
    elif name == "policy_vm":
        tables, env = vm_inputs(8)
        out = ops.policy_vm(torch.from_numpy(tables[:0]).to(cuda_device),
                            torch.from_numpy(env).to(cuda_device))
    elif name == "flash_attention":
        kv = torch.zeros((1, 128, 64), device=cuda_device)
        out = flash_attention_cuda(kv[:0], kv, kv, causal=True)
    elif name == "rowclone_copy":
        out = ops.rowclone_copy(torch.zeros((0, 8), device=cuda_device))
    elif name == "selective_scan":
        case = chip_smoke.ssm_case(torch, 2, 0, 24, 16, cuda_device)
        out, hT = ops.selective_scan(*case)
        assert torch.equal(hT, case[-1])
    elif name == "ref_scan":
        e = torch.empty((0, 64), dtype=torch.int32, device=cuda_device)
        costs = torch.empty((0, 2), dtype=torch.int32, device=cuda_device)
        out = ops.ref_scan(e, e, e, e, e, None, None, costs,
                           scan_params(0, 64))["t_resp"]
    elif name == "slot_scan_window":
        e = torch.empty((0, 64), dtype=torch.int32, device=cuda_device)
        costs = torch.empty((0, 2), dtype=torch.int32, device=cuda_device)
        st = emulator.EmulatorState.fresh(64, 16, 4, batch=0,
                                          device=cuda_device)
        out = ops.slot_scan_window(st, e, e, e, e, e, None, None, costs,
                                   scan_params(0, 64), True).t_resp
    else:
        e = torch.empty((0, 64), dtype=torch.int32, device=cuda_device)
        costs = torch.empty((0, 2), dtype=torch.int32, device=cuda_device)
        out = ops.slot_scan(e, e, e, e, e, None, None, costs,
                            scan_params(0, 64))["t_resp"]
    assert out.numel() == 0
    assert ops.launches()[name] == 0


# ---- the reference engine (ref_scan) and sharding on the card


def ref_case(name):
    return chip_smoke.ref_cases(np, emulator, smcprog, timescale, traces,
                                faults, bloom_mod)[name]


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.REF_CASES)
def test_ref_scan_matches_plain_on_the_cut_cases(cuda_device, case):
    """run_ref_many on the card (ref_scan) equals it on the CPU (the plain
    ref_scan_ref) on every field, and equals run_many on the card."""
    trs, sys_, kw = ref_case(case)
    ops.reset_launches()
    got = emulator.run_ref_many(trs, sys_, device=cuda_device, **kw)
    counts = ops.launches()
    assert counts["ref_scan"] > 0 and counts["slot_scan"] == 0
    want = emulator.run_ref_many(trs, sys_, device="cpu", **kw)
    chip_smoke.same_records(np, got, want, f"{case}: kernel vs plain")
    fast = emulator.run_many(trs, sys_, device=cuda_device, **kw)
    chip_smoke.same_records(np, got, fast, f"{case}: run_ref vs run")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["modes-bloom-shared", "runtime-policies"])
@pytest.mark.parametrize("shards", [1, 2])
def test_sharding_on_the_card_equals_unsharded(cuda_device, case, shards,
                                               monkeypatch):
    """'force' over the card (one shard), and two shards on the same card
    (the device lister monkeypatched): run_many and run_ref_many equal
    their unsharded records."""
    trs, sys_, kw = ref_case(case)
    base = [emulator.run_many(trs, sys_, device=cuda_device, **kw),
            emulator.run_ref_many(trs, sys_, device=cuda_device, **kw)]
    if shards == 2:
        monkeypatch.setattr(emulator, "local_devices", lambda device_type: [
            torch.device("cuda", torch.cuda.current_device())] * 2)
    old = emulator.set_sharding("force")
    try:
        got = [emulator.run_many(trs, sys_, device=cuda_device, **kw),
               emulator.run_ref_many(trs, sys_, device=cuda_device, **kw)]
    finally:
        emulator.set_sharding(old)
    for a, b, what in zip(got, base, ("run_many", "run_ref_many")):
        chip_smoke.same_records(np, a, b, f"{case} {what} x{shards}")


@pytest.mark.cuda
def test_ref_scan_cuda_refusals(cuda_device):
    e = torch.zeros((1, 64), dtype=torch.int32, device=cuda_device)
    costs = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    p = scan_params(1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ref_scan_cuda(e.cpu(), e.cpu(), e.cpu(), e.cpu(), e.cpu(), None,
                      None, costs.cpu(), p)
    words = torch.zeros((1, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="use_weak"):
        ref_scan_cuda(e, e, e, e, e, (words, 2, 128), None, costs, p)
    pw = dataclasses.replace(p, use_weak=1)
    with pytest.raises(ValueError, match="m_bits"):
        ref_scan_cuda(e, e, e, e, e, (words, 2, 256), None, costs, pw)


# ---------------- training ----------------

@pytest.mark.cuda
def test_flash_attention_raises_under_grad_on_the_card(cuda_device):
    """The CUDA route refuses autograd (the kernel's output would carry
    no gradient) and launches nothing; under ``no_grad`` it launches."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn((1, 128, 2, 64), generator=g, device=cuda_device)
    kv = torch.randn((1, 128, 1, 64), generator=g, device=cuda_device)
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q.clone().requires_grad_(), kv, kv)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention_bhsd(q[0].transpose(0, 1).contiguous(),
                                 kv[0].transpose(0, 1).contiguous()
                                 .requires_grad_(),
                                 kv[0].transpose(0, 1).contiguous())
    assert ops.launches()["flash_attention"] == 0
    with torch.no_grad():
        ops.flash_attention(q.clone().requires_grad_(), kv, kv)
    assert ops.launches()["flash_attention"] == 1


@pytest.mark.cuda
def test_two_fp32_train_steps_on_the_card_match_the_cpu(cuda_device):
    """The CPU tests' tiny qwen2 (tests/test_torch_train.py), the same
    float32 masters on both devices, 2 steps at float32 compute with TF32
    off: the CPU tests' tolerances (loss and grad norm rtol 1e-5; m and v
    within 1e-4 of each leaf's largest) and chip_smoke.py 13a's rule for
    the masters (in units of the summed lr: all within 2, all but 1e-4 of
    them within 1e-2); no kernel launches."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model_zoo, pdefs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step
    cfg = configs.get_config("qwen2_1_5b").scaled(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=128, head_dim=16)
    model = model_zoo.build(cfg, s_max=16)
    params = model.init(0, device="cpu")
    src = SyntheticLM(cfg.vocab_size, 16, 8, seed=3)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launches()
    try:
        runs = []
        for dev in ("cpu", cuda_device):
            state = opt.init_state(pdefs.tree_map(
                lambda t: t.to(dev, copy=True), params))
            step = make_train_step(model, opt.AdamWConfig(
                lr=1e-2, warmup=5, total_steps=50, clip_norm=0.05),
                compute_dtype=torch.float32)
            ms = []
            for i in range(2):
                state, m = step(state, src.batch(i))
                ms.append({k: float(v) for k, v in m.items()})
            runs.append((state, ms))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert ops.launches() == {n: 0 for n in ops.KERNELS}
    (cpu, cpu_m), (card, card_m) = runs
    assert card.master["embed"].device.type == "cuda"
    for a, b in zip(card_m, cpu_m):
        assert a["lr"] == b["lr"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    sum_lr = sum(m["lr"] for m in cpu_m)
    for name in ("m", "v"):
        for g, w in zip(pdefs.tree_leaves(getattr(card, name)),
                        pdefs.tree_leaves(getattr(cpu, name))):
            w = w.numpy()
            np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
    d = np.concatenate([(g.cpu() - w).abs().numpy().ravel() for g, w in zip(
        pdefs.tree_leaves(card.master), pdefs.tree_leaves(cpu.master))])
    assert d.max() <= chip_smoke.TRAIN_MASTER_BOUND * sum_lr
    assert (d > chip_smoke.TRAIN_MASTER_LR_TOL * sum_lr).mean() \
        <= chip_smoke.TRAIN_MASTER_TAIL


@pytest.mark.cuda
def test_moe_prefill_and_train_step_on_the_card_match_the_cpu(cuda_device):
    """A tiny granite-moe (4 experts top 2, as tests/test_torch_moe.py;
    head dim 64, the smallest the flash kernel takes) on the card against
    the CPU, the same float32 weights: the prefill
    (flash route, S = 128) at tests/test_torch_lm.py's float32 logits
    tolerance with the same routing in every layer, routing twice alike
    on the card, and one float32 train step's loss and moe_aux / moe_z
    at rtol 1e-5 (TF32 off)."""
    from repro_torch import configs
    from repro_torch.models import model_zoo, moe as moe_mod, pdefs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step
    cfg = configs.get_config("granite_moe_1b_a400m").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=64,
        moe=configs.MoEConfig(n_experts=4, top_k=2, d_ff=64))
    model = model_zoo.build(cfg, s_max=128)
    params = model.init(0, device="cpu")
    toks = np.random.RandomState(7).randint(0, 512, (2, 129))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    try:
        for dev in ("cpu", cuda_device, cuda_device):
            routes = chip_smoke.RouteRecorder(moe_mod)
            p = pdefs.tree_map(lambda t: t.to(dev, copy=True), params)
            ops.reset_launches()
            routes.start()
            try:
                with torch.no_grad():
                    logits, _ = model.prefill_fn(p, {"tokens": toks[:, :128]})
            finally:
                calls = routes.stop()
            launches = ops.launches()["flash_attention"]
            state, m = make_train_step(
                model, opt.AdamWConfig(lr=1e-2, warmup=5),
                compute_dtype=torch.float32)(
                    opt.init_state(p), {"tokens": toks[:, :-1],
                                        "targets": toks[:, 1:]})
            runs.append((logits.cpu(), [{k: v.cpu() for k, v in c.items()}
                                        for c in calls], launches,
                         {k: float(v) for k, v in m.items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    (cl, cr, cn, cm), (gl, gr, gn, gm), (gl2, gr2, _, _) = runs
    assert (cn, gn) == (0, cfg.n_layers)
    np.testing.assert_allclose(gl.numpy(), cl.numpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(gr, cr):
        assert torch.equal(a["idx"], b["idx"]) and torch.equal(a["keep"],
                                                                b["keep"])
    assert chip_smoke.same_routing(torch, gr, gr2) and torch.equal(gl, gl2)
    for k in ("loss", "moe_aux", "moe_z"):
        np.testing.assert_allclose(gm[k], cm[k], rtol=1e-5, err_msg=k)


# ---- the selective scan (mamba's prefill)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.SSM_CASES)
def test_selective_scan_kernel_matches_plain(cuda_device, shape):
    """y and hT within chip_smoke.SSM_TOL of their largest magnitude on
    chip_smoke.SSM_CASES (both d_states, batches 1 and 4, token counts
    past the 32-token tile, a tail block of channels, jamba's prefill),
    one launch counted per call."""
    case = chip_smoke.ssm_case(torch, *shape, cuda_device)
    ops.reset_launches()
    got = ops.selective_scan(*case)
    assert ops.launches()["selective_scan"] == 1
    want = ref.selective_scan_ref(*case)
    assert got[0].shape == case[0].shape and got[1].shape == case[-1].shape
    errs = chip_smoke.ssm_errors(torch, got, want)
    assert max(errs) <= chip_smoke.SSM_TOL, errs


@pytest.mark.cuda
def test_selective_scan_cuda_refusals(cuda_device):
    """d_state outside {8, 16}, a non-float32 or non-contiguous input, a
    CPU tensor and an input under autograd are refused before a launch."""
    case = chip_smoke.ssm_case(torch, 1, 40, 32, 16, cuda_device)
    ops.reset_launches()
    bad = chip_smoke.ssm_case(torch, 1, 40, 32, 4, cuda_device)
    with pytest.raises(ValueError, match="d_state"):
        selective_scan_cuda(*bad)
    with pytest.raises(ValueError, match="float32"):
        selective_scan_cuda(case[0].double(), *case[1:])
    with pytest.raises(ValueError, match="contiguous"):
        u = case[0].transpose(1, 2).contiguous().transpose(1, 2)
        selective_scan_cuda(u, *case[1:])
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(case[0].cpu(), *case[1:])
    with pytest.raises(NotImplementedError, match="backward"):
        ops.selective_scan(case[0].clone().requires_grad_(), *case[1:])
    assert ops.launches()["selective_scan"] == 0
