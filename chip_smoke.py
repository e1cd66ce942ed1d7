#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage (from the repository root, on a machine with an NVIDIA H100)::

    python3 chip_smoke.py

Phases, one line each:

1. build the CUDA kernels from the five sources in
   ``src/repro_torch/kernels/csrc``;
2. ``bloom_probe`` kernel against its plain version (the reference test
   grid, every global row id through the paper-size filter, and
   ``BLOOM_CASES``);
3. ``policy_vm`` kernel against its plain version (built-ins plus
   seeded random tables, env values that overflow int32; every bucket
   from 8 to 1024 on random, long and garbage tables);
4. ``slot_scan`` kernel (with ``bloom_probe``) against the plain engine
   on the card, through the engine's entry points, at reduced length;
4b. the shapes past ``slot_scan``'s fast instantiation (queues 65, 100,
   1016 and 1100, banks 65, 128 and 4096, policy tables 512 and 1024)
   through ``run`` / ``run_policies`` with the default device, the
   launch counters reset just before: every group runs in the wide
   instantiation and equals the plain engine (CPU worker processes) on
   all seven fields; the batch ``policy_vm`` at a 512-row table against
   its plain version;
5. the main path at full size with the launch counters reset just before
   it: the tRCD case study over twelve PolyBench kernels (base and
   reduced arms, ``ts`` and ``reference`` in one batch), the RowClone
   case study (copy and init at 64 KiB, 1 MiB, 4 MiB) and
   ``run_policies`` over the built-ins; every slot-scan group's output is
   checked as it comes (each real request served, with a response tag);
6. each kernel's launches on the main path, its time beside its plain
   version's and its bound (device time per launch and time per call);
   every main-path ``slot_scan`` group
   relaunched once: the scan's summed device time and ns per slot of the
   largest-slot and the largest-batch group, beside the phase-5 wall
   time; the policy group's ns per slot beside the same rows run as a
   legacy FR-FCFS group (the VM's cost inside the scan);
7. ``slot_scan`` against the plain engine over the main path's own
   groups, the plain engine running in CPU worker processes;
7b. fault injection: fault groups at a cut (the RowHammer study's policy
   group, the legacy scheduler under the same storms, PARA without a
   fault model, and the wide instantiation at a window of 80 and 128
   banks) held against the plain engine in CPU workers on every field,
   the fault fields included; then, with the counters reset just before
   it, ``RowHammerMitigationStudy`` at full size (``JETSON_NANO``, the
   study's fault model with retention on, its frfcfs / para / trr arms,
   five intensities, 131072 requests a trace): each arm's bit-error rate
   and slowdown, and the fault groups' ns per slot beside the same rows
   run with ``faults=None``;
7c. the stream path: with the counters reset just before it,
   ``run_stream_many`` over 8 ``synthetic_stream``s of 125000 requests
   (chunk 16384, ``JETSON_NANO``, ``ts``, ``collect='full'``: the repo's
   streaming configuration), each stream equal on every field to
   single-shot ``run_many`` of the same traces; requests/s of both, the
   window kernel's ns per request beside the single-shot kernel's, host
   ms per window by part, and peak device memory at 62500 and 125000
   requests a stream (equal); every window of the cut cases
   (``WINDOW_CASES``: legacy, policy tables, PARA without a fault model,
   the fault model, Bloom filters shared and stacked, the wide
   instantiation, a chunk equal to the halo, streams that drain early)
   against the plain window step (CPU worker processes); a 262144-line
   gzip trace file through an LLC, streamed, against ``load_trace_file``
   + ``run``; a Campaign mixing stream and batched points;
8. ``flash_attention`` and ``rowclone_copy`` against their plain
   versions on the reference kernel tests' grids;
9. the LM serving path at the full width of ``qwen3-8b`` (random float32
   weights from a seed, bf16 KV cache): ``ServeEngine.generate_batch``
   over 4 prompts of 1024 tokens, 16 new tokens each, with the launch
   counters reset just before it (the prefill launches ``flash_attention``
   once per layer); the same generation with ``flash_attention`` swapped
   for its plain version holds the prefill logits, the cache and the
   greedy tokens;
10. the KV-cache fork: one prompt's cache forked 4 ways through
   ``rowclone_copy`` (counters reset just before), bit for bit against the
   tiled fork, then 16 decode steps from each fork with identical logits;
11. device time by kernel of a full-width prefill, a decode step and a
   4-way fork, beside their wall time (the device's busy share), each
   over back-to-back calls spanning at least ``DEVICE_WINDOW_MS``;
12. each LM kernel's time at the serving path's shapes beside its plain
   version's, its bound and the PyTorch call that computes the same
   function (``scaled_dot_product_attention``, ``clone``), which the port
   itself never calls (``rowclone_copy`` and ``clone`` timed in turns);
   flash's bound is its 3xTF32 tensor-core bound, printed beside the fp32
   SIMT bound.

Device ms per launch comes from a profiled window of back-to-back calls
at least ``DEVICE_WINDOW_MS`` long, or from CUDA events when the trace
shows no launch; each entry names its method.

The engine's entry points launch ``bloom_probe`` and ``slot_scan`` (a
stream, ``slot_scan``'s window entry, counted as ``slot_scan_window``),
the serving engine ``flash_attention`` and ``rowclone_copy``; the
policy VM runs inside ``slot_scan`` (``csrc/policy_vm.cuh``) on every
decision of a policy group, so the batch ``policy_vm`` kernel is checked
and timed at phase 3's shapes and has no launches on the main path.

Exits non-zero on any failed check. The last two lines are the card's
name and power limit, then ``{"ok": true, "device": {...}}``. Details go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
DEVICE_WINDOW_MS = 20.0       # least span of a profiled window (device_ms)
SCALAR_OPS_PER_S = 67e12      # H100 SXM non-tensor float32 rate (data sheet)
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 tensor-core rate (data sheet)
REPLACES = {
    "bloom_probe": "src/repro/kernels/bloom_probe.py:21",
    "policy_vm": "src/repro/kernels/policy_vm.py:31",
    "slot_scan": "src/repro/core/emulator.py:531",
    "slot_scan_window": "src/repro/core/emulator.py:1645",
    "flash_attention": "src/repro/kernels/flash_attention.py:21",
    "rowclone_copy": "src/repro/kernels/rowclone_copy.py:18",
}
# the window entry is slot_scan.cu's fourth instantiation flag (kStream)
SOURCES = {name: "src/repro_torch/kernels/csrc/"
                 f"{'slot_scan' if name == 'slot_scan_window' else name}.cu"
           for name in REPLACES}
FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
          "smc_fpga_cycles", "t_resp", "t_issue")
PATH_KERNELS = ("bloom_probe", "slot_scan")   # launched by the entry points
N_POLYBENCH = 12          # POLYBENCH[:12] at max_accesses=60000 (phase 5)
SCAN_ACCESSES = 1000      # max_accesses of the phase-4 traces
PLAIN_SLOT_LIMIT = 65540  # slot budget of a full 32768-request group
MAX_WORKERS = 8           # CPU worker processes of phases 4b, 7, 7b and 7c
# phase 7b: the study's fault model with retention switched on, its
# intensities and its requests a trace (the size of the main path's
# largest RowClone group); FAULT_CUT requests a trace at the cut, whose
# groups the plain engine runs whole, and the full-size groups over as many
# slots as a cut trace has
STUDY_FM = dict(seed=7, hammer_threshold=48, hammer_flip_fp=52000,
                weak_fp=16000, retention_ticks=30)
STUDY_INTENSITIES = (0.1, 0.25, 0.45, 0.7, 0.9)
STUDY_REQUESTS = 131072
FAULT_CUT = 2048
FAULT_SLOT_LIMIT = 2 * FAULT_CUT + 4   # the slot budget of a cut trace
# phase 4b: (window or None for the default, banks, ops of a long policy
# program or 0, requests, dependences drawn below this); no dependences
# where the queue is to fill up to its window
WIDE_SHAPES = {"q65": (65, 16, 0, 200, 1), "q100": (100, 16, 0, 200, 3),
               "q1016": (1016, 16, 0, 1300, 1),
               "q1100": (1100, 16, 0, 1300, 1),
               "banks65": (None, 65, 0, 200, 3),
               "banks128": (None, 128, 0, 200, 3),
               "banks4096": (None, 4096, 0, 200, 3),
               "table512": (None, 16, 300, 40, 3),
               "table1024": (None, 16, 600, 24, 3)}
# phase 2 and the card tests: (batch, keys per row, m_bits, k, one filter
# per row): batches 1, 16 and 33; one key, and rows that are not a
# multiple of 4 (int4 loads across row starts, scalar heads and tails);
# filters from 2^5 to 2^23 bits (past L1); every k. The main path's shape
# is (16, 16384, 2^20, 4).
BLOOM_CASES = [(1, 1, 1 << 10, 1, False), (16, 16384, 1 << 20, 4, False),
               (33, 4097, 1 << 16, 3, True), (16, 1003, 1 << 23, 8, False),
               (33, 7, 1 << 21, 5, True), (1, 100003, 1 << 14, 2, False),
               (16, 2049, 1 << 20, 6, True), (2, 333, 1 << 12, 7, False),
               (3, 5, 32, 4, False), (1, 18, 64, 2, True)]
# phase 7c: the stream path at the repo's streaming configuration
# (benchmarks/paper.py bench_streaming): 8 synthetic streams of 125000
# requests, windows of 16384, JETSON_NANO, ts; a 262144-line gzip trace
# file through an LLC
STREAM_N, STREAM_REQUESTS, STREAM_CHUNK = 8, 125000, 16384
TRACE_FILE_LINES = 262144
# phase 7c and the card tests: stream cuts held window by window against
# the plain window step, (requests a stream, chunk) and the case's knobs:
# the fault model (STUDY_FM) with storm traces, policy tables (built-in or
# mitigation programs, one per stream), a Bloom filter shared or one per
# stream, the window and banks of the wide instantiation, a chunk equal to
# the halo, and streams that drain in an interior window
WINDOW_CUT, WINDOW_CUT_CHUNK = 3000, 256
WINDOW_CASES = {
    "legacy": {},
    "policy": {"tables": "builtin"},
    "para-no-fault-model": {"tables": "mitigation"},
    "faults-legacy": {"fault": True},
    "faults-policy": {"fault": True, "tables": "mitigation"},
    "bloom-shared": {"bloom": "shared"},
    "bloom-stacked": {"bloom": "stacked", "tables": "builtin"},
    "wide-q80-banks128": {"window": 80, "banks": 128},
    "wide-q80-banks128-faults": {"window": 80, "banks": 128, "fault": True,
                                 "tables": "mitigation"},
    "chunk-equals-halo": {"chunk": "halo", "n": 400},
    "drain-in-interior-window": {"lengths": (1.0, 0.2, 0.01, 0.0)},
}
VM_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)   # phase 3
LM_ARCH = "qwen3_8b"      # the serving path's model, at full width
LM_SEED = 0
LM_BATCH, LM_PROMPT, LM_NEW, FORK_N = 4, 1024, 16, 4
FLASH_GRID = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 8, 8, 128),
              (1, 128, 4, 1, 256)]     # tests/test_kernels.py
# the reference copy grid, the fork's shape class (36 rows written 4 row
# sizes apart, each larger than one block's chunk) and a large ragged copy
ROWCLONE_SHAPES = [(8, 128), (64, 512), (33, 257), (1, 8192), (36, 65664),
                   (3, 300007)]
# kernel vs plain on one attention call: the tolerances of
# tests/test_kernels.py (the kernel's online softmax sums in another order)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the whole prefill, kernel route vs plain route: 36 layers compound each
# layer's ~1e-6 relative attention difference through float32 matmuls;
# logits may differ by 1e-3 of their largest magnitude, each bf16 cache
# value by one bf16 ulp (2^-7 relative) plus 1e-4 of the leaf's largest
LOGIT_TOL = 1e-3
CACHE_RTOL, CACHE_ATOL = 2.0 ** -7, 1e-4


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=3):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel_name=None, window_ms=DEVICE_WINDOW_MS):
    """Device ms per launch of the CUDA kernels whose name contains
    ``kernel_name`` (per call of ``fn`` over all its device work when
    None), and how it was taken: the profiler's CUPTI trace over enough
    back-to-back calls of ``fn`` to span ``window_ms`` (short profiled
    sessions came back empty), else, when the trace still shows no such
    kernel, CUDA events over the same calls (ms per call)."""
    import torch
    reps = max(1, math.ceil(window_ms / max(cuda_ms(fn, reps=1), 1e-3)))
    rows, _ = profile_rows(torch, lambda: [fn() for _ in range(reps)])
    if kernel_name is None:
        total = sum(ms for _, ms, _ in rows)
        if total > 0:
            return total / reps, f"profiler, all device work of {reps} calls"
    else:
        hits = [(ms, n) for key, ms, n in rows if kernel_name in key]
        n = sum(c for _, c in hits)
        if n:
            return sum(ms for ms, _ in hits) / n, f"profiler, {n} launches"
    return cuda_ms(fn, reps=reps), f"cuda events, {reps} calls"


def device_fields(fn, kernel_name):
    """``device_ms`` and ``device_ms_method`` of a kernel's JSON entry."""
    ms, method = device_ms(fn, kernel_name)
    return {"device_ms": ms, "device_ms_method": method}


def turns_ms(fns, reps, rounds=3):
    """``{name: [ms per call, one per round]}``: the functions timed in
    turns (a, b, a, b, ...) with CUDA events, ``reps`` calls a round, so
    that two versions meet the same card state."""
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(cuda_ms(fn, reps=reps))
    return out


class Recorder:
    """Wraps the engine's kernel routing. ``record()`` keeps the largest
    ``bloom_probe`` inputs (``bloom_args``), every ``slot_scan`` group
    (its study's tag, inputs and host outputs), checking each group's
    service as it comes, and every ``slot_scan_window`` launch apart from
    them (``windows``: tag, inputs and the state it returned), checking
    each window's service: an interior window has served every request
    it retires and carried its frontier to the window's end, the final
    one has served every request and emptied its queue. ``plain()`` sends
    CUDA tensors to the plain versions instead."""

    def __init__(self, ops, ref, nop, big):
        self.ops, self.ref, self.nop, self.big = ops, ref, nop, big
        self.orig = {name: getattr(ops, name) for name in ops.KERNELS}
        self.bloom_args = None
        self.groups = []
        self.windows = []
        self.tag = ""

    def record(self):
        import torch
        o = self.orig

        def bp(words, keys, k, m_bits):
            if self.bloom_args is None \
                    or keys.numel() > self.bloom_args[1].numel():
                self.bloom_args = (words, keys, k, m_bits)
            return o["bloom_probe"](words, keys, k, m_bits)

        def ss(*args):
            out = o["slot_scan"](*args)
            real = args[0] != self.nop                # every non-NOP request
            check(torch.equal(out["served"], real.sum(1, dtype=torch.int32)),
                  f"{self.tag}: a request was not served")
            check(bool((out["t_resp"][real] < self.big).all()),
                  f"{self.tag}: a served request has no response tag")
            self.groups.append({"tag": self.tag, "args": args, "out": {
                f: v.cpu().numpy() for f, v in out.items()}})
            return out

        def ssw(st, kind, *rest):
            out = o["slot_scan_window"](st, kind, *rest)
            p, final = rest[-2], rest[-1]
            # the window's chunk, from its slot budget
            # (emulator.stream_slot_budget)
            chunk = (p.slots - 12) // 2 - max(p.window, 2)
            real = kind != self.nop
            served = out.t_resp < self.big
            if final:
                check(bool(served[real].all())
                      and bool((out.queue < 0).all())
                      and bool((out.ptr == p.n).all()),
                      f"{self.tag}: the final window left a request unserved")
            else:
                check(bool(served[:, :chunk][real[:, :chunk]].all())
                      and bool((out.ptr > p.n - 4).all()),
                      f"{self.tag}: a window retires an unserved request")
            self.windows.append({"tag": self.tag,
                                 "args": (st, kind) + tuple(rest),
                                 "out": out})
            return out

        self.ops.bloom_probe, self.ops.slot_scan = bp, ss
        self.ops.slot_scan_window = ssw

    def plain(self):
        r = self.ref
        self.ops.bloom_probe = r.bloom_probe_ref
        self.ops.slot_scan = r.slot_scan_ref
        self.ops.slot_scan_window = r.slot_scan_window_ref
        self.ops.policy_vm = r.policy_vm_ref

    def restore(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def random_table(rng, max_ops, name, smcprog):
    """A seeded random valid program of 2..max_ops rows over every opcode."""
    loads = list(range(smcprog.OP_AGE, smcprog.OP_PARA_RAND + 1))
    alu = sorted(smcprog._BINARY) + [smcprog.OP_NOT, smcprog.OP_SELECT]
    n = int(rng.randint(2, max_ops + 1))
    rows = []
    for i in range(n):
        if i == 0 or rng.random_sample() < 0.4:
            if rng.random_sample() < 0.3:
                rows.append((smcprog.OP_CONST, 0, 0,
                             int(rng.randint(-2 ** 31, 2 ** 31))))
            else:
                rows.append((int(rng.choice(loads)), 0, 0, 0))
            continue
        op = int(rng.choice(alu))
        a, b = int(rng.randint(i)), int(rng.randint(i))
        imm = int(rng.randint(i)) if op == smcprog.OP_SELECT else 0
        rows.append((op, a, 0 if op == smcprog.OP_NOT else b, imm))
    regs = rng.randint(-1, n, 2)
    return smcprog.PolicyProgram(tuple(rows), score_reg=n - 1,
                                 boost_reg=int(regs[0]),
                                 mitigate_reg=int(regs[1]),
                                 name=name).validate()


def bloom_case(np, B, n, m_bits, k, per_row):
    """Seeded int32 words ``[B or 1, m_bits / 32]`` (three bits in four
    set) and keys ``[B, n]`` over the whole uint32 range."""
    rng = np.random.RandomState(m_bits + k)
    shape = (B if per_row else 1, m_bits // 32)
    bits = rng.randint(0, 2 ** 32, shape, dtype=np.uint64) \
        | rng.randint(0, 2 ** 32, shape, dtype=np.uint64)
    keys = rng.randint(0, 2 ** 32, (B, n), dtype=np.uint64)
    return (bits.astype(np.uint32).view(np.int32),
            keys.astype(np.uint32).view(np.int32))


def garbage_tables(np, rng, P, L):
    """Tables of any opcode (the gaps and past the set too), operands
    before, at and past their row and outside the table, padding rows with
    non-zero imm, header registers negative and past the table."""
    t = rng.randint(-3, L + 3, (P, L + 1, 4)).astype(np.int64)
    t[:, 1:, 0] = rng.randint(-3, 31, (P, L))
    near = rng.random_sample((P, L)) < 0.7   # mostly earlier rows
    rows = np.arange(L)[None, :]
    t[:, 1:, 1] = np.where(near, np.maximum(rows - rng.randint(1, 6, (P, L)),
                                            0), t[:, 1:, 1])
    t[:, 1:, 3] = np.where(rng.random_sample((P, L)) < 0.5,
                           rng.randint(-2 ** 31, 2 ** 31, (P, L)),
                           t[:, 1:, 3])
    n_ops = rng.randint(1, L + 1, P)
    t[:, 0, 0] = n_ops
    t[:, 0, 1] = np.where(rng.random_sample(P) < 0.5, n_ops - 1, t[:, 0, 1])
    return t.astype(np.int32)


def long_program(smcprog, n_ops, name="long"):
    """A fault-free program of at most ``n_ops`` ops whose score chains
    age, age_rel and constants through every row, with a row-hit boost."""
    b = smcprog.PolicyBuilder()
    v = b.score_age()
    hit = b.score_row_hit()
    for _ in range((n_ops - 2) // 4):
        v = b.add(v, b.min_(b.age_rel(), b.const(7)))
    return b.build(score=v, boost=hit, name=name)


def window_case(np, emu, smcprog, timescale, traces, faults, name,
                n=WINDOW_CUT, chunk=WINDOW_CUT_CHUNK):
    """One ``WINDOW_CASES`` cut: ``(sys, traces, run_stream_many keyword
    arguments, chunk)``, the traces materialized (seeded) so that the same
    requests also run single-shot."""
    c = WINDOW_CASES[name]
    n = c.get("n", n)
    sys_ = timescale.JETSON_NANO
    if "window" in c:
        sys_ = dataclasses.replace(sys_, window=c["window"], geometry=(
            dataclasses.replace(sys_.geometry, n_banks=c["banks"])))
    geo = sys_.geometry
    lengths = [int(n * x) for x in c.get("lengths", (1.0, 1.0, 1.0))]
    if c.get("fault"):
        sys_ = sys_.with_faults(faults.FaultModel(**STUDY_FM))
        trs = [traces.rowhammer_trace(max(m, 1), geo, intensity=0.9,
                                      seed=i) for i, m in enumerate(lengths)]
    else:
        trs = [emu.Trace(*(np.concatenate([getattr(w, f) for w in ws])
                           for f in ("kind", "bank", "row", "delta",
                                     "dep")))
               for ws in ([w for w in traces.synthetic_stream(
                   max(m, 1), window=1000, seed=40 + i,
                   n_banks=geo.n_banks, n_rows=512, kinds=5, dep_max=5)]
                   for i, m in enumerate(lengths))]
    trs = [emu.Trace(*(getattr(t, f)[:m] for f in ("kind", "bank", "row",
                                                   "delta", "dep")))
           for t, m in zip(trs, lengths)]
    kw = {}
    if "tables" in c:
        progs = list((smcprog.builtin_programs() if c["tables"] == "builtin"
                      else smcprog.mitigation_programs(
                          para_fp=3277, trr_threshold=4)).values())
        progs = [progs[i % len(progs)] for i in range(len(trs))]
        kw = {"policies": progs,
              "policy_costs": [p.smc_cycles() for p in progs]}
    if "bloom" in c:
        from repro_torch.core.bloom import BloomFilter
        rng = np.random.RandomState(13)
        keys = [rng.randint(0, geo.n_banks * 512, 400).astype(np.uint32)
                for _ in trs]
        bfs = [BloomFilter.build(k, m_bits=1 << 12, k=3) for k in keys]
        kw["blooms"] = ((bfs[0].bits, 3, 1 << 12) if c["bloom"] == "shared"
                        else [(b.bits, 3, 1 << 12) for b in bfs])
    if c.get("chunk") == "halo":
        chunk = emu.stream_halo(sys_)
    return sys_, trs, kw, chunk


def state_fields(st):
    """An ``EmulatorState``'s tensors by name (bank and fault fields
    flattened)."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}.{k}": x for k, x in v.items()})
        else:
            out[f.name] = v
    return out


def window_inputs_cpu(args):
    """A recorded ``slot_scan_window`` call's inputs as CPU copies."""
    def cpu(v):
        if isinstance(v, dict):
            return {k: x.cpu() for k, x in v.items()}
        return v.cpu() if hasattr(v, "cpu") else v

    st = args[0]
    return (dataclasses.replace(st, **{f.name: cpu(getattr(st, f.name))
                                       for f in dataclasses.fields(st)}),
            ) + tuple(cpu(a) for a in args[1:])


def window_errors(ref, calls):
    """Each recorded window ``(inputs, kernel state)`` through the plain
    window step on CPU copies: ``{field: largest abs difference}``."""
    err = {}
    for args, got in calls:
        want = state_fields(ref.slot_scan_window_ref(*window_inputs_cpu(
            args)))
        got = state_fields(got)
        if set(got) != set(want):
            raise CheckFailed(f"slot_scan_window gives fields {sorted(got)}, "
                              f"the plain step {sorted(want)}")
        for f, w in want.items():
            e = int((got[f].cpu().long() - w.long()).abs().max()) \
                if w.numel() else 0
            err[f] = max(err.get(f, 0), e)
    return err


def same_results(a, b, label):
    for ra, rb in zip(a, b):
        for f in FIELDS:
            check((ra[f] == rb[f]).all(), f"{label}: {f} differs")
    check(len(a) == len(b), f"{label}: result counts differ")


def phase_bloom(torch, np, ops, ref, dev, bloom_mod, techniques, timescale):
    n_keys = 0
    for m_bits, k, n in ((1 << 14, 2, 100), (1 << 16, 4, 5000),
                         (1 << 18, 6, 20000)):
        keys_in = np.arange(0, n * 3, 3, dtype=np.uint32)
        bf = bloom_mod.BloomFilter.build(keys_in, m_bits=m_bits, k=k)
        words = bloom_mod.words_tensor(bf.bits, dev).unsqueeze(0)
        probes = torch.arange(0, n * 4, dtype=torch.int32,
                              device=dev).unsqueeze(0)
        got = ops.bloom_probe(words, probes, k, m_bits)
        want = ref.bloom_probe_ref(words, probes, k, m_bits)
        check(torch.equal(got, want), f"bloom_probe != plain at {m_bits},{k}")
        ins = torch.from_numpy(keys_in.view(np.int32)).to(dev).unsqueeze(0)
        check(bool(ops.bloom_probe(words, ins, k, m_bits).all()),
              f"bloom_probe false negative at {m_bits},{k}")
        n_keys += probes.numel()
    trcd = techniques.TRCDReduction(timescale.JETSON_NANO)
    bf = trcd.characterize()
    geo = timescale.JETSON_NANO.geometry
    ids = torch.arange(geo.n_banks * geo.n_rows, dtype=torch.int32,
                       device=dev).unsqueeze(0)
    words = bloom_mod.words_tensor(bf.bits, dev).unsqueeze(0)
    got = ops.bloom_probe(words, ids, bf.k, bf.m_bits)
    check(torch.equal(got, ref.bloom_probe_ref(words, ids, bf.k, bf.m_bits)),
          "bloom_probe != plain over all row ids")
    weak = torch.from_numpy(trcd.device.weak.reshape(-1)).to(dev)
    fn = int((weak & (got[0] == 0)).sum())
    check(fn == 0, f"{fn} false negatives over all row ids")
    fp = float((~weak & (got[0] != 0)).sum()) / max(int((~weak).sum()), 1)
    for case in BLOOM_CASES:
        words, keys = (torch.from_numpy(a).to(dev)
                       for a in bloom_case(np, *case))
        got = ops.bloom_probe(words, keys, case[3], case[2])
        check(torch.equal(got, ref.bloom_probe_ref(words, keys, case[3],
                                                   case[2])),
              f"bloom_probe != plain at {case}")
    say(f"phase 2 bloom_probe: exact on {n_keys} grid keys and "
        f"{ids.numel()} row ids, 0 false negatives, false-positive rate "
        f"{fp:.6f}; exact on {len(BLOOM_CASES)} shapes (batches 1-33, "
        f"filters 2^5-2^23 bits, k 1-8, per-row filters)")


def phase_policy(torch, np, ops, ref, dev, smcprog):
    rng = np.random.RandomState(0)
    q = 64
    env = rng.randint(0, 64, (smcprog.N_LOADS, q)).astype(np.int64)
    # ages near the int32 edge (age - age and age * const overflow),
    # negative rr_dist operands, and full-range values on half the lanes
    env[0] = rng.randint(2 ** 30, 2 ** 31, q)
    env[1] = rng.randint(-2 ** 31, 2 ** 31, q)
    env[7] = rng.randint(-40, 16, q)
    env[:, q // 2:] = rng.randint(-2 ** 31, 2 ** 31,
                                  (smcprog.N_LOADS, q - q // 2))
    envm = torch.from_numpy(env.astype(np.int32)).to(dev)
    progs = list(smcprog.builtin_programs().values()) \
        + list(smcprog.mitigation_programs().values())
    n = len(progs)
    for bucket, max_ops in ((8, 8), (16, 16)):
        pool = [p for p in progs if smcprog.table_bucket(p.n_ops) <= bucket]
        pool += [random_table(rng, max_ops, f"r{bucket}_{i}", smcprog)
                 for i in range(128)]
        tables = torch.from_numpy(smcprog.pack_stack(pool, bucket)).to(dev)
        got = ops.policy_vm(tables, envm)
        check(torch.equal(got, ref.policy_vm_ref(tables, envm)),
              f"policy_vm != plain in bucket {bucket}")
        n += 128
    vm_tables = tables
    for bucket in VM_BUCKETS:
        pool = [long_program(smcprog, bucket - 3)] + [
            random_table(rng, bucket, f"r{bucket}_{i}", smcprog)
            for i in range(8)]
        t = np.concatenate([smcprog.pack_stack(pool, bucket),
                            garbage_tables(np, rng, 16, bucket)])
        for lanes in (1, 80, 200):
            tt = torch.from_numpy(t).to(dev)
            e = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (
                smcprog.N_LOADS, lanes)).astype(np.int32)).to(dev)
            got = ops.policy_vm(tt, e)
            check(torch.equal(got.cpu(), ref.policy_vm_ref(tt.cpu(),
                                                           e.cpu())),
                  f"policy_vm != plain in bucket {bucket}, {lanes} lanes")
        n += len(t)
    say(f"phase 3 policy_vm: exact on {n} tables (buckets 8 to 1024; "
        f"built-in, random, long and garbage tables) over {q}-, 1-, 80- "
        f"and 200-lane envs with int32 overflow")
    return vm_tables, envm


def phase_scan(np, rec, emu, techniques, timescale, traces, smcprog, geo,
               dev):
    t0 = time.perf_counter()
    trs = []
    for i in (0, 3, 12, 16):
        tr, _ = traces.polybench_trace(traces.POLYBENCH[i], geo,
                                       max_accesses=SCAN_ACCESSES)
        trs.append(tr)
    jn = timescale.JETSON_NANO
    trcd = techniques.TRCDReduction(jn)
    bl = trcd.bloom_tuple
    other = trcd.device.weak_rows()[::2]
    bl2 = (techniques.BloomFilter.build(other).bits, bl[1], bl[2])
    builtins = list(smcprog.builtin_programs().values())
    cases = [
        ("modes", lambda: emu.run_many(
            trs * 3, jn, ["ts"] * 4 + ["reference"] * 4 + ["nots"] * 4,
            device=dev)),
        ("fcfs", lambda: emu.run_many(
            trs, dataclasses.replace(jn, scheduler="fcfs"), "nots",
            device=dev)),
        ("staged", lambda: emu.run_many(
            trs, jn.with_policy(smcprog.bank_round_robin_program()), "nots",
            device=dev)),
        ("policies", lambda: emu.run_policies(trs[0], jn, builtins,
                                              mode="nots", device=dev)),
        ("shared-bloom", lambda: emu.run_many(trs, jn, "ts", blooms=bl,
                                              device=dev)),
        ("per-trace-bloom", lambda: emu.run_many(
            trs, jn, "ts", blooms=[bl, bl2, bl, bl2], device=dev)),
    ]
    times = {}
    for label, fn in cases:
        rec.restore()
        t1 = time.perf_counter()
        got = fn()
        t2 = time.perf_counter()
        rec.plain()
        want = fn()
        t3 = time.perf_counter()
        rec.restore()
        same_results(got, want, label)
        for r in got:
            check(int(r["served"]) == r["n_requests"], f"{label}: unserved")
        times[label] = (t2 - t1, t3 - t2)
    n_req = [t.n for t in trs]
    say(f"phase 4 slot_scan: kernel == plain engine on all 7 fields for "
        f"{len(cases)} cases ({', '.join(times)}) over PolyBench traces of "
        f"{n_req} requests (max_accesses={SCAN_ACCESSES}); kernel "
        f"{sum(a for a, _ in times.values()):.2f} s vs plain "
        f"{sum(b for _, b in times.values()):.2f} s; "
        f"{time.perf_counter() - t0:.1f} s")
    return times


def phase_wide(np, torch, ops, ref, emu, smcprog, timescale, vm_env, dev):
    """The shapes past ``slot_scan``'s fast instantiation, which the card
    refused before this slice, through the engine's entry points with the
    default device; every group against the plain engine on all seven
    fields (CPU worker processes); the batch ``policy_vm`` at a 512-row
    table. Returns the launches, the instantiations and a detail dict."""
    from repro_torch.kernels.slot_scan import instantiation
    jn = timescale.JETSON_NANO
    cases = []
    for i, (name, (window, banks, n_ops, n, dep_max)) in enumerate(
            WIDE_SHAPES.items()):
        sys_ = dataclasses.replace(
            jn, window=window or jn.window,
            geometry=dataclasses.replace(jn.geometry, n_banks=banks))
        rng = np.random.RandomState(i)
        tr = emu.Trace.of(rng.randint(0, 5, n), rng.randint(0, banks, n),
                          rng.randint(0, 64, n), rng.randint(0, 6, n),
                          rng.randint(0, dep_max, n))
        progs = [long_program(smcprog, n_ops)] if n_ops else None
        cases.append((name, sys_, tr, progs))
    rec = Recorder(ops, ref, emu.NOP, emu.BIG)
    torch.cuda.synchronize()
    ops.reset_launches()
    rec.record()
    t0 = time.perf_counter()
    for name, sys_, tr, progs in cases:
        rec.tag = name
        if progs:
            emu.run_policies(tr, sys_, progs, mode="nots")
        else:
            for mode in ("ts", "nots"):
                emu.run(tr, sys_, mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = ops.launches(), ops.variants()
    rec.restore()
    groups = rec.groups
    check(counts["slot_scan"] == len(groups) == sum(variants.values())
          and all(k.startswith("slot_scan/wide") for k in variants),
          f"phase 4b: {len(groups)} groups, launches {counts}, "
          f"instantiations {variants}")
    kern = rec.orig["slot_scan"]
    timed = []
    for g in groups:
        p = g["args"][-1]
        ms = cuda_ms(lambda: kern(*g["args"]), reps=2)
        timed.append({"tag": g["tag"], "instantiation": instantiation(p),
                      "batch": p.batch, "n": p.n, "q": p.q,
                      "banks": p.n_banks, "table": p.table_len,
                      "slots": p.slots, "ms": ms,
                      "ns_per_slot": ms * 1e6 / p.slots})
    jobs = [(g["tag"], True, g["args"][-1], g["args"][:-1], g["out"])
            for g in groups]
    err, plain = compare_plain(np, jobs)

    tables = torch.from_numpy(smcprog.pack_stack(
        [long_program(smcprog, 509)] + list(
            smcprog.builtin_programs().values()), 512)).to(dev)
    ops.reset_launches()
    got = ops.policy_vm(tables, vm_env)
    torch.cuda.synchronize()
    vm_variant = ops.variants()
    vm_err = float((got - ref.policy_vm_ref(tables, vm_env)).abs().max())
    check(vm_err == 0, f"policy_vm != plain at a 512-row table ({vm_err})")
    vm_ms = cuda_ms(lambda: ops.policy_vm(tables, vm_env), reps=5)
    say(f"phase 4b wide shapes: slot_scan == plain engine on all 7 fields "
        f"for {len(cases)} shapes ({', '.join(WIDE_SHAPES)}) in "
        f"{len(groups)} groups, launches {counts['slot_scan']} "
        f"{variants}, {wall:.2f} s; kernel ns per slot "
        + ", ".join(f"{t['tag']} {t['ns_per_slot']:.0f}" for t in timed)
        + f"; plain engine {plain['plain_cpu_s']:.1f} CPU-s in "
        f"{plain['workers']} processes; policy_vm exact at "
        f"{list(tables.shape)} x {vm_env.shape[1]} lanes {vm_variant} "
        f"{vm_ms:.4f} ms")
    return {"launches": counts["slot_scan"], "instantiations": variants,
            "wall_s": wall, "groups": timed, "plain": plain,
            "max_abs_err": err, "policy_vm_512": {
                "shape": list(tables.shape), "lanes": vm_env.shape[1],
                "instantiation": vm_variant, "ms": vm_ms}}


def phase_main(np, torch, ops, rec, emu, techniques, timescale, traces,
               campaign, smcprog, geo, dev):
    jn = timescale.JETSON_NANO
    t0 = time.perf_counter()
    trs = []
    for kern in traces.POLYBENCH[:N_POLYBENCH]:
        tr, _ = traces.polybench_trace(kern, geo)
        trs.append(tr)
    trcd = techniques.TRCDReduction(jn, techniques.DeviceModel(geo))
    bloom = trcd.bloom_tuple
    rc = techniques.RowClone(jn)
    t_setup = time.perf_counter() - t0

    torch.cuda.synchronize()
    ops.reset_launches()
    rec.record()
    t1 = time.perf_counter()
    rec.tag = "trcd"
    trcd_res = trcd.evaluate_traces(trs, device=dev)
    t2 = time.perf_counter()
    c = campaign.Campaign()
    for i, tr in enumerate(trs):
        for mode in ("ts", "reference"):
            c.add(tr, jn, mode=mode, bloom=bloom, i=i)
    rec.tag = "ts-reference"
    tsref = c.run(device=dev)
    t3 = time.perf_counter()
    sizes = [64 << 10, 1 << 20, 4 << 20]
    rc_res = {}
    for w in ("copy", "init"):
        rec.tag = f"rowclone-{w}"
        rc_res[w] = rc.evaluate_batch(sizes, workload=w, device=dev)
    t4 = time.perf_counter()
    builtins = list(smcprog.builtin_programs().values())
    rec.tag = "policies"
    pol_res = emu.run_policies(trs[0], jn, builtins, device=dev)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    counts = ops.launches()
    rec.restore()

    by = {(r["i"], r["mode"]): r for r in tsref}
    for i, r in enumerate(trcd_res):
        a, b = by[(i, "ts")], by[(i, "reference")]
        for f in FIELDS:
            check((a[f] == b[f]).all(), f"trace {i}: ts != reference on {f}")
        check(int(a["exec_cycles"]) == r["reduced_cycles"],
              f"trace {i}: campaign and TRCDReduction disagree")
    for r in tsref + pol_res:      # the recorder checked every group's service
        check(int(r["served"]) == r["n_requests"], "a request was not served")
        check(np.isfinite(r["exec_seconds"]) and r["exec_cycles"] > 0,
              "bad exec time")
    for w, res in rc_res.items():
        for d in res:
            check(d["rowclone"].speedup_vs_cpu > 1.0,
                  f"RowClone {w} at {d['cpu'].n_bytes} B not faster")
    n_req = sum(t.n_real for t in trs)
    # reduced tRCD shifts every later decision, so a trace can end a little
    # later than at nominal tRCD (seen on the card): phase 7 runs the
    # tRCD groups of every such trace whole through the plain engine
    speed = [round(r["speedup"], 4) for r in trcd_res]
    slower = [i for i, r in enumerate(trcd_res)
              if r["reduced_cycles"] > r["base_cycles"]]
    rcs = {w: [round(d["rowclone"].speedup_vs_cpu, 2) for d in res]
           for w, res in rc_res.items()}
    say(f"phase 5 main path: tRCD over {len(trs)} PolyBench kernels "
        f"({n_req} DRAM requests) {t2 - t1:.2f} s, speedups {speed} "
        f"(traces {slower} slower at reduced tRCD); ts == "
        f"reference exactly in one batch ({t3 - t2:.2f} s); RowClone "
        f"speedups {rcs} ({t4 - t3:.2f} s); policy sweep over "
        f"{len(builtins)} built-ins {t5 - t4:.2f} s; trace setup "
        f"{t_setup:.1f} s; launches {counts}")
    detail = {"trcd": trcd_res, "rowclone": {
        w: [{a: dataclasses.asdict(d[a]) for a in ("cpu", "rowclone")}
            for d in res] for w, res in rc_res.items()},
        "policies": {p.name: int(r["exec_cycles"])
                     for p, r in zip(builtins, pol_res)},
        "wall_s": {"trcd": t2 - t1, "ts_reference": t3 - t2,
                   "rowclone": t4 - t3, "policies": t5 - t4,
                   "trace_setup": t_setup},
        "n_requests": n_req, "slower_at_reduced_trcd": slower}
    return counts, detail, {emu._bucket(trs[i].n) for i in slower}


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(torch, ops, ref, rec, counts, vm_args):
    """Each kernel's time beside its plain version's and its bound:
    ``bloom_probe`` and ``slot_scan`` on the main path's largest inputs,
    the batch ``policy_vm`` (not launched by the entry points) at phase
    3's bucket-16 inputs."""
    if rec.bloom_args is None or not rec.groups:
        raise CheckFailed("the main path recorded no kernel inputs")
    big = max(rec.groups, key=lambda g: (g["args"][-1].slots,
                                         g["args"][-1].batch))
    inputs = {"bloom_probe": rec.bloom_args,
              "policy_vm": vm_args, "slot_scan": big["args"]}
    n_vm = sum(g["args"][-1].table_len > 0 for g in rec.groups)
    out = []
    for name in ("bloom_probe", "policy_vm", "slot_scan"):
        args = inputs[name]
        kern = rec.orig[name]
        plain = getattr(ref, {"bloom_probe": "bloom_probe_ref",
                              "policy_vm": "policy_vm_ref",
                              "slot_scan": "slot_scan_ref"}[name])
        if name == "bloom_probe":
            words, keys, k, m_bits = args
            got, want = kern(*args), plain(*args)
            err = float((got.int() - want.int()).abs().max())
            ms = cuda_ms(lambda: kern(*args), reps=20)
            extra = device_fields(lambda: kern(*args), "bloom_probe_kernel")
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            nbytes = words.numel() * 4 + keys.numel() * 5
            nops = keys.numel() * k * 14
            shape = f"words {list(words.shape)}, keys {list(keys.shape)}"
        elif name == "policy_vm":
            tables, envm = args
            got, want = kern(*args), plain(*args)
            err = float((got - want).abs().max())
            ms = cuda_ms(lambda: kern(*args), reps=20)
            extra = {**device_fields(lambda: kern(*args), "policy_vm_kernel"),
                     "on_path": f"its VM body (policy_vm.cuh) ran inside "
                                f"slot_scan in {n_vm} main-path groups"}
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            P, L1, _ = tables.shape
            Q = envm.shape[1]
            nbytes = tables.numel() * 4 + envm.numel() * 4 + P * 3 * Q * 4
            nops = P * Q * (L1 - 1) * 15
            shape = (f"phase 3 tables {list(tables.shape)}, env "
                     f"{list(envm.shape)}")
        else:
            p = args[-1]
            ms = cuda_ms(lambda: kern(*args), reps=2)
            # the plain engine on the card is ~1e3 launches per slot: time
            # it on the same inputs over a cut slot budget, and the kernel
            # too; with no slots the kernel runs only its closing passes
            cut = dataclasses.replace(p, slots=min(p.slots, 200))
            cargs = args[:-1] + (cut,)
            kc, pc = kern(*cargs), plain(*cargs)
            err = max(float((kc[f] - pc[f]).abs().max()) for f in FIELDS)
            plain_ms = cuda_ms(lambda: plain(*cargs), reps=1)
            closing = args[:-1] + (dataclasses.replace(p, slots=0),)
            extra = {**device_fields(lambda: kern(*args), "slot_scan_kernel"),
                     "slots": p.slots, "plain_slots": cut.slots,
                     "kernel_ms_at_plain_slots": cuda_ms(
                         lambda: kern(*cargs), reps=3),
                     "kernel_ms_at_0_slots": cuda_ms(
                         lambda: kern(*closing), reps=3),
                     "ns_per_slot": ms * 1e6 / p.slots}
            B, N = p.batch, p.n
            nbytes = B * N * (5 * 4 + 2 * 4) + B * 5 * 4 \
                + (B * N if args[5] is not None else 0) \
                + (args[6].numel() * 4 if args[6] is not None else 0)
            nops = B * p.slots * (200 + 15 * p.table_len * p.q)
            shape = (f"{big['tag']} group, batch {B} x {N} requests, "
                     f"{p.slots} slots")
        check(err == 0, f"{name} differs from its plain version on the main "
                        f"path inputs (max abs err {err})")
        bms, bby = bound_ms(nbytes, nops)
        out.append({"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": counts[name],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": bby, "library_ms": None,
                    "shape": shape, **extra})
    return out


def scan_totals(torch, rec, wall_s):
    """The main path's ``slot_scan`` launches, each group relaunched once
    on its own inputs: their summed device ms (one profiled window; CUDA
    events per group when the trace shows fewer launches than groups),
    and ns per budget slot of the largest-slot and the largest-batch
    group, beside the engine's phase-5 wall time."""
    kern = rec.orig["slot_scan"]
    groups = rec.groups
    per = [cuda_ms(lambda: kern(*g["args"]), reps=1) for g in groups]
    rows, _ = profile_rows(torch, lambda: [kern(*g["args"]) for g in groups])
    hits = [(ms, n) for key, ms, n in rows if "slot_scan_kernel" in key]
    n = sum(c for _, c in hits)
    if n == len(groups):
        total, method = sum(ms for ms, _ in hits), f"profiler, {n} launches"
    else:
        total, method = sum(per), f"cuda events, {len(per)} groups"

    def at(i):
        p = groups[i]["args"][-1]
        return {"tag": groups[i]["tag"], "batch": p.batch, "n": p.n,
                "slots": p.slots, "ms": per[i],
                "ns_per_slot": per[i] * 1e6 / p.slots}
    idx = range(len(groups))
    by_slots = at(max(idx, key=lambda i: (groups[i]["args"][-1].slots,
                                         groups[i]["args"][-1].batch)))
    by_batch = at(max(idx, key=lambda i: (groups[i]["args"][-1].batch,
                                         groups[i]["args"][-1].slots)))
    # the VM's cost inside the scan: the policy group against its own rows
    # run as a legacy FR-FCFS group (no table), in turns
    pol = next(g for g in groups if g["args"][-1].table_len > 0)
    pargs = pol["args"]
    pp = pargs[-1]
    largs = pargs[:6] + (None, pargs[7], dataclasses.replace(
        pp, table_len=0, frfcfs=1))
    tt = turns_ms({"policy": lambda: kern(*pargs),
                   "legacy": lambda: kern(*largs)}, reps=3)
    vm_cost = {"tag": pol["tag"], "batch": pp.batch, "n": pp.n,
               "table_len": pp.table_len, "slots": pp.slots,
               "ms": {k: min(v) for k, v in tt.items()},
               **{f"{k}_ns_per_slot": min(v) * 1e6 / pp.slots
                  for k, v in tt.items()}}
    say(f"phase 6 policy VM inside slot_scan: the {pol['tag']} group "
        f"({pp.batch} x {pp.n}, {pp.table_len}-row tables, {pp.slots} "
        f"slots) {vm_cost['policy_ns_per_slot']:.1f} ns per slot, its rows "
        f"as a legacy FR-FCFS group {vm_cost['legacy_ns_per_slot']:.1f}")
    engine_s = sum(v for k, v in wall_s.items() if k != "trace_setup")
    say(f"phase 6 slot_scan over its {len(groups)} main-path launches: "
        f"{total:.3f} ms of device time ({method}); largest-slot group "
        f"({by_slots['tag']}, {by_slots['batch']} x {by_slots['n']}, "
        f"{by_slots['slots']} slots) {by_slots['ns_per_slot']:.1f} ns per "
        f"slot, largest-batch group ({by_batch['tag']}, {by_batch['batch']} "
        f"x {by_batch['n']}, {by_batch['slots']} slots) "
        f"{by_batch['ns_per_slot']:.1f} ns per slot; engine wall (phase 5) "
        f"{engine_s:.2f} s, trace setup {wall_s['trace_setup']:.2f} s")
    return {"launches": len(groups), "device_ms_total": total,
            "device_ms_method": method,
            "largest_slots": by_slots, "largest_batch": by_batch,
            "policy_vm_in_scan": vm_cost,
            "engine_wall_s": engine_s,
            "trace_setup_s": wall_s["trace_setup"], "per_group_ms": per}


def plain_scan_job(arrays, params):
    """One recorded group through the plain engine on the CPU, in a worker
    process; returns its output fields and the seconds it took."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.slot_scan import ScanParams
    torch.set_num_threads(1)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in arrays.items()}
    t0 = time.perf_counter()
    out = ref.slot_scan_ref(t["kind"], t["bank"], t["row"], t["delta"],
                            t["dep"], t["weak"], t["tables"], t["costs"],
                            ScanParams(**params))
    return {f: v.numpy() for f, v in out.items()}, time.perf_counter() - t0


def phase_plain_groups(np, rec, slower_buckets):
    """``slot_scan`` against the plain engine over the main path's groups.

    The plain engine is launch-bound on the card (~4 ms per slot), so it
    runs on the CPU, one group per worker process, on the same inputs.
    Groups of up to ``PLAIN_SLOT_LIMIT`` slots are compared whole with
    their main-path outputs, as are both tRCD arms of every trace that
    ended later at reduced tRCD; a longer group is compared over its first
    ``PLAIN_SLOT_LIMIT`` slots, the kernel relaunched with that budget.
    The ts / reference groups are left out: their rows repeat the tRCD
    reduced arm's inputs, and phase 5 holds ts == reference exactly."""
    jobs = [scan_job(rec, g, PLAIN_SLOT_LIMIT,
                     g["tag"] == "trcd" and g["args"][-1].n in slower_buckets)
            for g in rec.groups if g["tag"] != "ts-reference"]
    err, detail = compare_plain(np, jobs)
    say(f"phase 7 slot_scan == plain engine on all 7 fields over "
        f"{detail['groups']} main-path groups "
        f"({', '.join(sorted({j[0] for j in jobs}))}): {detail['whole']} "
        f"whole, {detail['groups'] - detail['whole']} over their first "
        f"{PLAIN_SLOT_LIMIT} slots; {detail['slots']} slots, plain engine "
        f"{detail['plain_cpu_s']:.1f} CPU-s in {detail['workers']} "
        f"processes, {detail['wall_s']:.1f} s")
    return err, detail


def scan_job(rec, g, limit, whole=False):
    """A recorded ``slot_scan`` group as a ``compare_plain`` job: whole if
    ``whole`` or its budget is at most ``limit`` slots, else over its first
    ``limit`` slots, the kernel relaunched on its inputs with that budget."""
    args, p = g["args"][:-1], g["args"][-1]
    whole = whole or p.slots <= limit
    got = g["out"]
    if not whole:
        p = dataclasses.replace(p, slots=limit)
        got = {f: v.cpu().numpy()
               for f, v in rec.orig["slot_scan"](*args, p).items()}
    return g["tag"], whole, p, args, got


def compare_plain(np, jobs):
    """Each job ``(tag, whole, params, input tensors, kernel outputs)``
    through the plain engine on the CPU, one group per worker process,
    held on every field (seven, and seven more with a fault model);
    returns the largest difference (0) and a detail dict."""
    names = ("kind", "bank", "row", "delta", "dep", "weak", "tables",
             "costs")
    jobs = [(tag, whole, p, {n: None if a is None else a.cpu().numpy()
                             for n, a in zip(names, args)}, got)
            for tag, whole, p, args, got in jobs]
    # longest first: the plain engine's cost is per slot, x2.5 with a table
    jobs.sort(key=lambda j: -j[2].slots * (5 if j[2].table_len else 2))
    workers = min(len(jobs), len(os.sched_getaffinity(0)), MAX_WORKERS)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(plain_scan_job, j[3], dataclasses.asdict(j[2]))
                for j in jobs]
        results = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    err = 0
    for (tag, whole, p, _, got), (want, _) in zip(jobs, results):
        check(set(got) == set(want), f"slot_scan and the plain engine give "
                                     f"other fields in a {tag} group")
        for f in want:
            e = int(np.abs(got[f].astype(np.int64)
                           - want[f].astype(np.int64)).max())
            err = max(err, e)
            check(e == 0, f"slot_scan != plain engine on {f} in a {tag} "
                          f"group ({p.batch} x {p.n}, {p.slots} slots)")
    slots = sum(j[2].slots for j in jobs)
    cpu_s = sum(s for _, s in results)
    return err, {"groups": len(jobs), "whole": sum(j[1] for j in jobs),
                 "slots": slots, "plain_cpu_s": cpu_s, "workers": workers,
                 "wall_s": wall,
                 "plain_ms_per_slot": cpu_s * 1e3 / max(slots, 1)}


def phase_faults(np, torch, ops, ref, emu, techniques, timescale, traces,
                 faults):
    """Fault injection on the card: fault groups at a cut, then the
    RowHammer study at full size through its entry point (counters reset
    just before) and its traces under the legacy scheduler with and
    without the fault model, the fault path's cost, and every group against
    the plain engine (the full-size ones over their first
    ``FAULT_SLOT_LIMIT`` slots, relaunched with that budget)."""
    from repro_torch.kernels.slot_scan import variant
    jn = timescale.JETSON_NANO
    fm = faults.FaultModel(**STUDY_FM)
    study = techniques.RowHammerMitigationStudy(jn, fault_model=fm)
    para = study.programs[next(n for n in study.programs
                               if n.startswith("para"))]
    wide_sys = dataclasses.replace(
        jn, window=80, geometry=dataclasses.replace(jn.geometry,
                                                    n_banks=128))
    cut = [traces.rowhammer_trace(FAULT_CUT, jn.geometry, intensity=x,
                                  seed=i)
           for i, x in enumerate((0.45, 0.9))]
    wide_tr = traces.rowhammer_trace(FAULT_CUT, wide_sys.geometry,
                                     intensity=0.7, seed=3)
    rec = Recorder(ops, ref, emu.NOP, emu.BIG)
    cases = [
        ("study-cut", lambda: study.evaluate((0.45, 0.9),
                                             n_requests=FAULT_CUT)),
        ("legacy-cut", lambda: emu.run_many(cut, jn.with_faults(fm))),
        ("para-no-model", lambda: emu.run_policies(cut[1], jn, [para])),
        ("wide-cut", lambda: emu.run_policies(
            wide_tr, wide_sys.with_faults(fm),
            list(study.programs.values()))),
    ]
    torch.cuda.synchronize()
    ops.reset_launches()
    rec.record()
    for tag, fn in cases:
        rec.tag = tag
        fn()
    torch.cuda.synchronize()
    cut_variants = ops.variants()
    rec.restore()
    check(set(cut_variants) == {"slot_scan/fast-faults",
                                "slot_scan/wide-shared"},
          f"phase 7b: the cut ran {cut_variants}")
    cut_rec = rec

    # the study at full size, through its entry point
    rec = Recorder(ops, ref, emu.NOP, emu.BIG)
    torch.cuda.synchronize()
    ops.reset_launches()
    rec.record()
    rec.tag = "study"
    t0 = time.perf_counter()
    res = study.evaluate(STUDY_INTENSITIES, n_requests=STUDY_REQUESTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = ops.launches(), ops.variants()
    # the same storms under the legacy FR-FCFS scheduler, with and without
    # the fault model (outside the counted run)
    full = [traces.rowhammer_trace(STUDY_REQUESTS, jn.geometry, intensity=x,
                                   seed=i)
            for i, x in enumerate(STUDY_INTENSITIES)]
    rec.tag = "legacy-faults"
    emu.run_many(full, jn.with_faults(fm))
    rec.tag = "legacy-none"
    emu.run_many(full, jn)
    rec.restore()
    check(counts["slot_scan"] > 0
          and set(variants) == {"slot_scan/fast-faults"},
          f"phase 7b: the study ran {counts} {variants}")
    arms = list(study.programs)
    for d in res:
        for name in arms:
            r = d[name]
            check(0.0 <= r["bit_error_rate"] <= 1.0
                  and r["exec_cycles"] > 0, f"study {name} at "
                                            f"{d['intensity']}: {r}")
    top = res[-1]
    check(top[study.baseline]["flips"] > 0,
          "the study's unmitigated arm flipped nothing at 0.9")
    check(all(top[n]["mitigations"] > 0 for n in arms
              if n != study.baseline), "a mitigation never fired at 0.9")

    # the fault path's cost: each group beside the same rows without the
    # fault model, as the engine builds them (the fault scalars are the
    # fields with defaults; a PARA row still draws, with faults=1)
    kern = rec.orig["slot_scan"]
    by_tag = {g["tag"]: g for g in rec.groups}
    p = by_tag["study"]["args"][-1]
    p_none = type(p)(**{f.name: getattr(p, f.name)
                        for f in dataclasses.fields(p)
                        if f.default is dataclasses.MISSING},
                     **emu._fault_params(jn, True))
    timing = {}
    pairs = {
        "study": (by_tag["study"]["args"],
                  by_tag["study"]["args"][:-1] + (p_none,)),
        "legacy": (by_tag["legacy-faults"]["args"],
                   by_tag["legacy-none"]["args"]),
    }
    for name, (a_on, a_off) in pairs.items():
        tt = turns_ms({"faults": lambda: kern(*a_on),
                       "none": lambda: kern(*a_off)}, reps=3)
        p = a_on[-1]
        timing[name] = {
            "batch": p.batch, "n": p.n, "slots": p.slots,
            "table_len": p.table_len,
            "variants": [variant(a_on[-1]), variant(a_off[-1])],
            "ms": tt, **{f"{k}_ns_per_slot": min(v) * 1e6 / p.slots
                         for k, v in tt.items()}}
    # every group against the plain engine: the cut groups whole, the full
    # size groups over their first FAULT_SLOT_LIMIT slots (as phase 7)
    jobs = [scan_job(cut_rec, g, FAULT_SLOT_LIMIT) for g in cut_rec.groups]
    check(all(j[1] for j in jobs), "phase 7b: a cut group is not whole")
    jobs += [scan_job(rec, g, FAULT_SLOT_LIMIT) for g in rec.groups]
    err, plain = compare_plain(np, jobs)
    say(f"phase 7b faults: slot_scan == plain engine on all fields "
        f"(fault fields included) over {len(cut_rec.groups)} cut groups "
        f"whole ({', '.join(t for t, _ in cases)}; {FAULT_CUT} requests a "
        f"trace) {cut_variants} and the {len(rec.groups)} full-size groups "
        f"({', '.join(g['tag'] for g in rec.groups)}) over their first "
        f"{FAULT_SLOT_LIMIT} slots; plain engine {plain['plain_cpu_s']:.1f} "
        f"CPU-s in {plain['workers']} processes, {plain['wall_s']:.1f} s")
    say(f"phase 7b RowHammer study ({len(STUDY_INTENSITIES)} intensities x "
        f"{len(arms)} arms, {STUDY_REQUESTS} requests a trace, fault model "
        f"{STUDY_FM}): {wall:.2f} s, launches {counts['slot_scan']} "
        f"{variants}")
    for d in res:
        say(f"  intensity {d['intensity']}: " + "; ".join(
            f"{n} BER {d[n]['bit_error_rate']:.6f} flips {d[n]['flips']} "
            f"mitigations {d[n]['mitigations']} slowdown "
            f"{d[n]['slowdown_vs_unmitigated']:.4f}" for n in arms))
    for name, t in timing.items():
        say(f"phase 7b {name} group ({t['batch']} x {t['n']}, "
            f"{t['slots']} slots, {t['variants'][0]} vs {t['variants'][1]}): "
            f"{t['faults_ns_per_slot']:.1f} ns per slot with the fault "
            f"model, {t['none_ns_per_slot']:.1f} with faults=None")
    return err, {"cut": {"variants": cut_variants, "plain": plain},
                 "study": res, "wall_s": wall,
                 "launches": counts["slot_scan"], "variants": variants,
                 "timing": timing}


def plain_window_job(state, arrays, params, final):
    """One recorded stream window through the plain window step on the
    CPU, in a worker process: its state fields and the seconds it took."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.core.state import EmulatorState
    from repro_torch.kernels import ref
    from repro_torch.kernels.slot_scan import ScanParams
    torch.set_num_threads(1)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in arrays.items()}
    st = EmulatorState.from_host(state)
    t0 = time.perf_counter()
    out = ref.slot_scan_window_ref(st, t["kind"], t["bank"], t["row"],
                                   t["delta"], t["dep"], t["weak"],
                                   t["tables"], t["costs"],
                                   ScanParams(**params), final)
    return ({k: v.numpy() for k, v in state_fields(out).items()},
            time.perf_counter() - t0)


def compare_plain_windows(np, windows):
    """Every recorded window against the plain window step on the CPU, one
    window per job in worker processes, on every state field; returns the
    largest difference (0) and a detail dict."""
    names = ("kind", "bank", "row", "delta", "dep", "weak", "tables",
             "costs")
    jobs = []
    for w in windows:
        st, rest = w["args"][0], w["args"][1:]
        arrays = {n: None if a is None else a.cpu().numpy()
                  for n, a in zip(names, rest[:8])}
        jobs.append((w, st.to_host(), arrays,
                     dataclasses.asdict(rest[8]), bool(rest[9])))
    # longest first: the plain step's cost is per slot, more with a table
    # or a fault model
    jobs.sort(key=lambda j: -j[3]["slots"] * (5 if j[3]["table_len"] else 2)
              * (3 if j[3]["faults"] else 1))
    workers = min(len(jobs), len(os.sched_getaffinity(0)), MAX_WORKERS)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(plain_window_job, *j[1:]) for j in jobs]
        results = [f.result() for f in futs]
    err = 0
    for (w, *_), (want, _) in zip(jobs, results):
        got = {k: v.cpu().numpy() for k, v in state_fields(w["out"]).items()}
        check(set(got) == set(want), f"{w['tag']}: slot_scan_window and the "
                                     f"plain step give other fields")
        for f in want:
            e = int(np.abs(got[f].astype(np.int64)
                           - want[f].astype(np.int64)).max()) \
                if want[f].size else 0
            err = max(err, e)
            check(e == 0, f"slot_scan_window != plain window step on {f} in "
                          f"a {w['tag']} window")
    cpu_s = sum(t for _, t in results)
    return err, {"windows": len(jobs), "plain_cpu_s": cpu_s,
                 "workers": workers, "wall_s": time.perf_counter() - t0}


def same_stream(np, got, want, n, label):
    """A stream's result against single-shot (``want``): every int field,
    the first n per-request tags, the mean latency and the fault fields."""
    for f in FIELDS[:5]:
        check(int(got[f]) == int(want[f]), f"{label}: {f} differs")
    for f in ("avg_load_latency_cycles", "exec_seconds", "n_requests",
              "mode"):
        check(got[f] == want[f], f"{label}: {f} differs")
    if "t_resp" in got:
        for f in ("t_resp", "t_issue"):
            check(np.array_equal(got[f], want[f][:n]), f"{label}: {f} "
                                                       f"differs")
    if "flips" in want:
        for f in ("flips", "ham_flips", "ret_flips", "mitigations",
                  "victim_bank", "victim_row", "victim_t", "bit_error_rate"):
            check(np.array_equal(got[f], want[f]), f"{label}: {f} differs")


def materialize(np, emu, windows):
    """One Trace from an iterable of Trace windows."""
    ws = list(windows)
    return emu.Trace(*(np.concatenate([getattr(w, f) for w in ws])
                       for f in ("kind", "bank", "row", "delta", "dep")))


def phase_stream(np, torch, ops, ref, emu, smcprog, timescale, traces,
                 faults, cachesim, campaign):
    """Phase 7c, the stream path: (i) the repo's streaming configuration
    at full size through ``run_stream_many`` (counters reset just before),
    held on every field against single-shot ``run_many`` of the same
    traces; its rates, the window kernel's ns per request beside the
    single-shot kernel's, host ms per window by part, and peak device
    memory at two stream lengths; (ii) ``WINDOW_CASES`` at the cut, each
    window against the plain window step (CPU workers); (iii) a gzip trace
    file through an LLC, streamed against ``load_trace_file`` + ``run``;
    (iv) a Campaign mixing stream and batched points. Returns the largest
    difference (0), the window kernel's JSON entry and a detail dict."""
    import gc
    import gzip
    import shutil
    import tempfile
    jn = timescale.JETSON_NANO
    geo = jn.geometry
    rec = Recorder(ops, ref, emu.NOP, emu.BIG)

    def streams(n):
        return [lambda i=i: traces.synthetic_stream(n, window=STREAM_CHUNK,
                                                    seed=i)
                for i in range(STREAM_N)]

    # (i) full size, the counters reset just before
    torch.cuda.synchronize()
    ops.reset_launches()
    rec.record()
    rec.tag = "stream"
    t0 = time.perf_counter()
    res = emu.run_stream_many(streams(STREAM_REQUESTS), jn, "ts",
                              chunk=STREAM_CHUNK, collect="full")
    torch.cuda.synchronize()
    stream_wall = time.perf_counter() - t0
    counts, variants = ops.launches(), ops.variants()
    windows = list(rec.windows)
    check(counts["slot_scan_window"] == len(windows) > 1
          and counts["slot_scan"] == 0,
          f"phase 7c: the stream path launched {counts}")
    trs = [materialize(np, emu, traces.synthetic_stream(
        STREAM_REQUESTS, window=STREAM_CHUNK, seed=i))
        for i in range(STREAM_N)]
    rec.tag = "single-shot"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = emu.run_many(trs, jn, "ts")
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    rec.restore()
    for i, (a, b) in enumerate(zip(res, single)):
        same_stream(np, a, b, STREAM_REQUESTS, f"stream {i}")
    total = STREAM_N * STREAM_REQUESTS
    check(sum(int(r["served"]) for r in res) == total
          and all(r["t_resp"].shape == (STREAM_REQUESTS,) for r in res),
          "phase 7c: the streams did not serve every request")

    # the window kernel on its recorded windows beside the single-shot
    # kernel on its group, each relaunched on its own inputs
    kern_w = rec.orig["slot_scan_window"]
    kern_s = rec.orig["slot_scan"]
    win_ms = [cuda_ms(lambda w=w: kern_w(*w["args"]), reps=2)
              for w in windows]
    group = rec.groups[-1]
    gp = group["args"][-1]
    single_ms = cuda_ms(lambda: kern_s(*group["args"]), reps=2)
    rows, _ = profile_rows(torch, lambda: [kern_w(*w["args"])
                                           for w in windows])
    hits = [(ms, n) for key, ms, n in rows if "slot_scan_window" in key]
    prof_n = sum(c for _, c in hits)
    win_total = sum(ms for ms, _ in hits) if prof_n == len(windows) \
        else sum(win_ms)
    win_method = (f"profiler, {prof_n} launches" if prof_n == len(windows)
                  else f"cuda events, {len(windows)} launches")
    wp = windows[0]["args"][-2]
    kernel_cmp = {
        "window_ms_total": win_total, "window_ms_method": win_method,
        "windows": len(windows), "window_slots_budget": wp.slots,
        "window_ns_per_request": win_total * 1e6 / STREAM_REQUESTS,
        "window_ns_per_budget_slot": win_total * 1e6 / (len(windows)
                                                        * wp.slots),
        "single_ms": single_ms, "single_slots": gp.slots,
        "single_ns_per_request": single_ms * 1e6 / STREAM_REQUESTS,
        "single_ns_per_slot": single_ms * 1e6 / gp.slots}

    # host ms per window by part, and peak device memory at two lengths
    timings = {}
    emu.run_stream_many(streams(STREAM_REQUESTS), jn, "ts",
                        chunk=STREAM_CHUNK, collect="aggregate",
                        timings=timings)
    n_win = len(windows)
    host_ms = {k: v * 1e3 / n_win for k, v in timings.items()}
    peak = {}
    for n in (STREAM_REQUESTS // 2, STREAM_REQUESTS):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        emu.run_stream_many(streams(n), jn, "ts", chunk=STREAM_CHUNK,
                            collect="aggregate")
        torch.cuda.synchronize()
        peak[n] = torch.cuda.max_memory_allocated() - base
    check(len(set(peak.values())) == 1,
          f"phase 7c: peak device memory grows with the stream: {peak}")

    # the kernel entry: time per launch, the plain window step on the same
    # inputs over a cut slot budget (the plain engine is ~1e3 launches a
    # slot on the card), the bound of the bytes each window must move and
    # of 200 operations per served and per issued request it advanced
    big = max(windows, key=lambda w: int((w["out"].served_n
                                          - w["args"][0].served_n).sum()))
    bargs, bp = big["args"], big["args"][-2]
    cut = bargs[:-2] + (dataclasses.replace(bp, slots=200), bargs[-1])
    kc, pc = state_fields(kern_w(*cut)), state_fields(
        ref.slot_scan_window_ref(*cut))
    check(set(kc) == set(pc), "slot_scan_window and the plain window step "
                              "give other fields")
    err = max(int((kc[f].long() - pc[f].long()).abs().max())
              for f in pc if pc[f].numel())
    check(err == 0, f"slot_scan_window != plain window step at a cut "
                    f"budget (max abs err {err})")
    plain_ms = cuda_ms(lambda: ref.slot_scan_window_ref(*cut), reps=1)
    B, L = bp.batch, bp.n
    bytes_w = B * L * (5 * 4 + 2 * 4 * 2) + B * (bp.q * 8 + 9 * 8
                                               + 3 * bp.n_banks * 8)
    advanced = sum(int((w["out"].served_n - w["args"][0].served_n).sum())
                   + int((w["out"].ptr - w["args"][0].ptr).sum())
                   for w in windows)
    bms, bby = bound_ms(bytes_w * len(windows), advanced * 200)
    entry = {"name": "slot_scan_window", "route": "cuda",
             "source": SOURCES["slot_scan_window"],
             "replaces": REPLACES["slot_scan_window"],
             "launches": counts["slot_scan_window"], "max_abs_err": 0,
             "ms": sum(win_ms) / len(win_ms), "plain_ms": plain_ms,
             "bound_ms": bms / len(windows), "bound_by": bby,
             "library_ms": None,
             "shape": (f"{B} streams x {STREAM_REQUESTS} requests, window "
                       f"{L} ({STREAM_CHUNK} + halo), {bp.slots} budget "
                       f"slots"),
             "plain_slots": 200, "kernel_ms_at_plain_slots": cuda_ms(
                 lambda: kern_w(*cut), reps=3),
             "variants": variants, **kernel_cmp}

    # (ii) the cut cases, every window against the plain window step
    rec = Recorder(ops, ref, emu.NOP, emu.BIG)
    rec.record()
    cut_variants = {}
    for name in WINDOW_CASES:
        sys_, trs_c, kw, chunk = window_case(np, emu, smcprog, timescale,
                                             traces, faults, name)
        rec.tag = name
        ops.reset_launches()
        got = emu.run_stream_many(trs_c, sys_, chunk=chunk, **kw)
        cut_variants[name] = ops.variants()
        for i, (tr, a, b) in enumerate(zip(trs_c, got, emu.run_many(
                trs_c, sys_, **kw))):
            same_stream(np, a, b, tr.n, f"{name} stream {i}")
    rec.restore()
    check(any(k.endswith("wide-shared") for v in cut_variants.values()
              for k in v)
          and any(k.endswith("fast-faults") for v in cut_variants.values()
                  for k in v), f"phase 7c: the cuts ran {cut_variants}")
    cut_windows = [w for w in rec.windows]
    e2, plain = compare_plain_windows(np, cut_windows)
    err = max(err, e2)

    # (iii) a gzip trace file through an LLC, streamed against the whole
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        path = os.path.join(tmp, "synthetic.trace.gz")
        src = materialize(np, emu, traces.synthetic_stream(
            TRACE_FILE_LINES, window=65536, seed=99, n_banks=geo.n_banks,
            n_rows=geo.n_rows))
        addr = ((src.row.astype(np.int64) * geo.n_banks + src.bank)
                * geo.row_bytes + (src.delta.astype(np.int64) * 64)
                % geo.row_bytes)
        with gzip.open(path, "wt") as fh:
            for i, (a, k) in enumerate(zip(addr.tolist(),
                                           src.kind.tolist())):
                fh.write(f"{i}, {'WriteReq' if k else 'ReadReq'}, "
                         f"{hex(a)}, 64\n" if i % 16 == 0 else
                         f"{hex(a)} {'W' if k else 'R'}\n")
        t0 = time.perf_counter()
        got = emu.run_stream(
            lambda: traces.iter_trace_file_windows(
                path, geo, window=STREAM_CHUNK, llc=cachesim.LLC()),
            jn, "ts", chunk=STREAM_CHUNK)
        file_stream_s = time.perf_counter() - t0
        whole = traces.load_trace_file(path, geo, llc=cachesim.LLC())
        same_stream(np, got, emu.run(whole, jn, "ts"), whole.n,
                    "trace file")
        check(got["n_requests"] == whole.n_real > TRACE_FILE_LINES // 2,
              "phase 7c: the trace file's stream lost requests")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (iv) a Campaign mixing stream and batched points
    ctr = [materialize(np, emu, traces.synthetic_stream(
        20000, window=4000, seed=70 + i, kinds=5, dep_max=4))
        for i in range(2)]
    bf = window_case(np, emu, smcprog, timescale, traces, faults,
                     "bloom-shared")[2]["blooms"]
    c = campaign.Campaign()
    c.add(ctr[0], jn, arm="batch")
    c.add(lambda: traces.iter_windows(ctr[0], 3000), jn, stream=True,
          chunk=4096, arm="stream")
    c.add(ctr[1], jn, mode="nots", bloom=bf, arm="batch-bloom")
    c.add(lambda: traces.iter_windows(ctr[1], 5000), jn, mode="nots",
          bloom=bf, stream=True, chunk=4096, arm="stream-bloom")
    c.add(ctr[1], jn, mode="reference", arm="batch-ref")
    recs = {r["arm"]: r for r in c.run(stream_collect="full")}
    same_stream(np, recs["stream"], recs["batch"], ctr[0].n, "campaign")
    same_stream(np, recs["stream-bloom"], recs["batch-bloom"], ctr[1].n,
                "campaign bloom")

    say(f"phase 7c stream: {STREAM_N} x {STREAM_REQUESTS} requests "
        f"(chunk {STREAM_CHUNK}) == single-shot run_many on every field; "
        f"{len(windows)} window launches {variants}; stream "
        f"{total / stream_wall:.0f} requests/s end to end (generation "
        f"included) vs single-shot {total / single_wall:.0f} requests/s "
        f"(traces materialized beforehand): ratio "
        f"{single_wall / stream_wall:.3f}")
    say(f"phase 7c window kernel: {kernel_cmp['window_ns_per_request']:.1f} "
        f"ns per request a row over {len(windows)} windows "
        f"({kernel_cmp['window_ns_per_budget_slot']:.1f} ns per budget "
        f"slot, {win_method}); single-shot kernel on the same traces "
        f"{kernel_cmp['single_ns_per_request']:.1f} ns per request "
        f"({kernel_cmp['single_ns_per_slot']:.1f} ns per slot, "
        f"{gp.slots} slots)")
    say("phase 7c host ms per window: " + ", ".join(
        f"{k} {v:.3f}" for k, v in host_ms.items())
        + f" (with a device sync closing each part); peak device memory "
          f"{peak} bytes at {list(peak)} requests a stream")
    say(f"phase 7c cuts: every window of {len(WINDOW_CASES)} cases "
        f"({', '.join(WINDOW_CASES)}) == plain window step on every state "
        f"field ({plain['windows']} windows, {plain['plain_cpu_s']:.1f} "
        f"CPU-s in {plain['workers']} processes, {plain['wall_s']:.1f} s); "
        f"trace file ({TRACE_FILE_LINES} lines, gzip, LLC: {whole.n} DRAM "
        f"requests, streamed in {file_stream_s:.2f} s) == load_trace_file "
        f"+ run; Campaign of {len(c)} points in {c.n_groups()} groups: "
        f"stream == batched points")
    return err, entry, {
        "wall_s": {"stream": stream_wall, "single_shot": single_wall},
        "requests_per_s": {"stream": total / stream_wall,
                           "single_shot": total / single_wall},
        "kernel": kernel_cmp, "host_ms_per_window": host_ms,
        "peak_device_bytes": peak, "cut_variants": cut_variants,
        "cut_plain": plain, "trace_file_requests": whole.n,
        "trace_file_stream_s": file_stream_s}


def close(got, want, atol, rtol):
    """Elementwise ``|got - want| <= atol + rtol * |want|`` (numpy's
    allclose) on float32 copies; returns (ok, max abs err)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return bool((diff <= atol + rtol * w.abs()).all()), float(diff.max())


def phase_lm_kernels(torch, ops, ref, dev):
    """``flash_attention`` on the reference flash test grid (float32 and
    bf16, causal and not) and ``rowclone_copy`` on the reference copy
    grid plus the fork's shape class and a large ragged copy (float32,
    bf16, int8; fresh, into slot 1 of FORK_N strided slots, from an
    unaligned base) against their plain versions on the card."""
    errs = {}
    n = 0
    for B, S, H, KV, hd in FLASH_GRID:
        for dt in ("float32", "bfloat16"):
            for causal in (True, False):
                g = torch.Generator(device=dev).manual_seed(B * S + H)
                q, k, v = (torch.randn(shape, generator=g, device=dev).to(
                    getattr(torch, dt)) for shape in
                    ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
                got = ops.flash_attention(q, k, v, causal=causal)
                flat = [t.permute(0, 2, 1, 3).reshape(-1, S, hd)
                        for t in (q, k, v)]
                want = (ref.flash_attention_ref(*flat, causal)
                        .reshape(B, H, S, hd).permute(0, 2, 1, 3))
                tol = FLASH_TOL[dt]
                ok, err = close(got, want, tol, tol)
                check(ok and got.dtype == q.dtype,
                      f"flash_attention != plain at {(B, S, H, KV, hd)} {dt} "
                      f"causal={causal} (max abs err {err})")
                errs[dt] = max(errs.get(dt, 0.0), err)
                n += 1
    n_copy = 0
    for shape in ROWCLONE_SHAPES:
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            x = torch.arange(shape[0] * shape[1], device=dev).reshape(
                shape).to(dt)
            check(torch.equal(ops.rowclone_copy(x), ref.rowclone_copy_ref(x)),
                  f"rowclone_copy != plain at {shape} {dt}")
            wide = torch.zeros((shape[0], FORK_N, shape[1]), dtype=dt,
                               device=dev)
            want = torch.zeros_like(wide)
            ops.rowclone_copy(x, out=wide[:, 1])
            ref.rowclone_copy_ref(x, out=want[:, 1])
            check(torch.equal(wide, want),
                  f"rowclone_copy into strided rows != plain at {shape} {dt}")
            odd = torch.arange(x.numel() + 1, device=dev).to(dt)[1:].view(
                shape)
            check(torch.equal(ops.rowclone_copy(odd), odd),
                  f"rowclone_copy from an unaligned base at {shape} {dt}")
            n_copy += 3
    torch.cuda.synchronize()
    say(f"phase 8 LM kernels: flash_attention == plain on {n} cases "
        f"(max abs err fp32 {errs['float32']:.3g} <= {FLASH_TOL['float32']}, "
        f"bf16 {errs['bfloat16']:.3g} <= {FLASH_TOL['bfloat16']}); "
        f"rowclone_copy exact on {n_copy} copies")
    return errs


class LMRecorder:
    """Wraps a model's ``prefill_fn`` / ``decode_fn`` to keep their logits
    and the prefill cache, and ``ops.flash_attention_bhsd`` to keep the
    first call's inputs; ``plain_flash`` sends that call to the plain
    version instead of the kernel."""

    def __init__(self, model, ops, ref):
        self.model, self.ops, self.ref = model, ops, ref
        self.orig = (model.prefill_fn, model.decode_fn,
                     ops.flash_attention_bhsd)
        self.flash_args = None
        self.run = None

    def start(self, plain_flash=False):
        prefill, decode, flash = self.orig
        run = self.run = {"prefill": None, "steps": [], "prefill_s": 0.0}

        def rec_flash(q, k, v, causal=True):
            if self.flash_args is None:
                self.flash_args = (q, k, v, causal)
            return (self.ref.flash_attention_ref if plain_flash else flash)(
                q, k, v, causal)

        def rec_prefill(params, batch):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch)
            torch.cuda.synchronize()
            run["prefill_s"] += time.perf_counter() - t0
            run["prefill"] = (logits, cache)
            return logits, cache

        def rec_decode(params, cache, token, pos):
            logits, cache = decode(params, cache, token, pos)
            run["steps"].append(logits)
            return logits, cache

        self.model.prefill_fn = rec_prefill
        self.model.decode_fn = rec_decode
        self.ops.flash_attention_bhsd = rec_flash

    def stop(self):
        (self.model.prefill_fn, self.model.decode_fn,
         self.ops.flash_attention_bhsd) = self.orig
        return self.run


def margins(torch, logits, vocab):
    """Top-1 minus top-2 logit per row, ``[B]``."""
    top = torch.topk(logits[:, -1, :vocab].float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def phase_serve(torch, np, ops, ref, dev, lm):
    """The serving path at full width; returns the flash launches, the
    model, its parameters, the prompts and the recorder."""
    configs, model_zoo, engine_mod = lm
    cfg = configs.get_config(LM_ARCH)
    s_max = LM_PROMPT + LM_NEW
    model = model_zoo.build(cfg, s_max=s_max)
    t0 = time.perf_counter()
    params = model.init(LM_SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = engine_mod.ServeEngine(model, params, s_max=s_max)
    prompts = np.random.RandomState(LM_SEED).randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    rec = LMRecorder(model, ops, ref)

    torch.cuda.synchronize()
    ops.reset_launches()
    rec.start()
    t1 = time.perf_counter()
    tokens = engine.generate_batch(prompts, LM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t1
    counts = ops.launches()
    kern = rec.stop()
    check(counts["flash_attention"] == cfg.n_layers,
          f"the prefill launched flash_attention {counts['flash_attention']} "
          f"times, not once per layer ({cfg.n_layers})")
    check(tokens.shape == (LM_BATCH, LM_NEW)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"generated tokens out of range or of shape {tokens.shape}")

    rec.start(plain_flash=True)
    tokens_plain = engine.generate_batch(prompts, LM_NEW)
    torch.cuda.synchronize()
    plain = rec.stop()

    (lk, ck), (lp, cp) = kern["prefill"], plain["prefill"]
    check(bool(torch.isfinite(lk).all()), "non-finite prefill logits")
    scale = float(lp.abs().max())
    logit_err = float((lk - lp).abs().max())
    check(logit_err <= LOGIT_TOL * scale,
          f"prefill logits: kernel route vs plain differ by {logit_err} "
          f"(> {LOGIT_TOL} x {scale})")
    cache_err = 0.0
    for pos in ck:
        for name in ck[pos]:
            a, b = ck[pos][name], cp[pos][name]
            check(a.dtype == torch.bfloat16 and a.shape == (
                cfg.n_layers, LM_BATCH, LM_PROMPT, cfg.n_kv_heads,
                cfg.resolved_head_dim), f"cache {pos}.{name}: {a.dtype} "
                                        f"{tuple(a.shape)}")
            ok, err = close(a, b, CACHE_ATOL * float(b.abs().max()),
                            CACHE_RTOL)
            check(ok, f"prefill cache {pos}.{name}: kernel route vs plain "
                      f"differ by {err}")
            cache_err = max(cache_err, err)
    # greedy tokens agree wherever the plain route's top-2 margin exceeds
    # the logit tolerance; after a legitimate split a row is not compared
    steps = [lp] + plain["steps"]
    marg = torch.stack([margins(torch, s, cfg.vocab_size) for s in steps],
                       1).cpu().numpy()
    compared = split = 0
    for b in range(LM_BATCH):
        for t in range(LM_NEW):
            if tokens[b, t] == tokens_plain[b, t]:
                compared += 1
                continue
            check(marg[b, t] <= LOGIT_TOL * scale,
                  f"row {b} step {t}: greedy tokens differ at a top-2 "
                  f"margin {marg[b, t]} above the tolerance")
            split += 1
            break
    n_tok = LM_BATCH * LM_NEW
    decode_s = t_gen - kern["prefill_s"]
    detail = {"arch": LM_ARCH, "n_params": model.n_params(),
              "init_s": t_init, "generate_s": t_gen,
              "prefill_s": kern["prefill_s"],
              "prefill_plain_flash_s": plain["prefill_s"],
              "decode_s": decode_s,
              "decode_ms_per_step": decode_s * 1e3 / (LM_NEW - 1),
              "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / kern["prefill_s"],
              "logit_err": logit_err, "logit_scale": scale,
              "cache_err": cache_err, "tokens_compared": compared,
              "rows_split_at_small_margin": split,
              "min_margin": float(marg.min()),
              "tokens": tokens.tolist(),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    say(f"phase 9 serve {cfg.name} full width ({model.n_params() / 1e9:.2f} B "
        f"params fp32, init {t_init:.2f} s): {LM_BATCH} x {LM_PROMPT} prompt "
        f"tokens, {LM_NEW} new, {t_gen:.2f} s (prefill "
        f"{kern['prefill_s']:.2f} s, decode {detail['decode_ms_per_step']:.1f} "
        f"ms per step); flash_attention launches {counts['flash_attention']}; "
        f"kernel vs plain route: logits max err {logit_err:.3g} (scale "
        f"{scale:.3g}), cache max err {cache_err:.3g}, {compared} of "
        f"{n_tok} greedy tokens equal, {split} rows split at margins <= "
        f"tolerance")
    return counts["flash_attention"], detail, model, params, prompts, rec


def profile_rows(torch, fn):
    """Device time by kernel name (CUPTI) of one call of ``fn``, largest
    first, and the call's wall milliseconds (synchronized)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0))
        if us > 0:
            rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows, wall


def phase_profile(torch, model, params, prompts, fork, fork_fn):
    """Where a full-width prefill's, a decode step's and a fork's time
    goes: device time by kernel and the device's busy share of the wall
    time, over enough back-to-back calls to span ``DEVICE_WINDOW_MS``
    (a lone fork's profile came back empty)."""
    out = {}
    with torch.no_grad():
        runs = {"prefill": lambda: model.prefill_fn(params,
                                                    {"tokens": prompts}),
                "decode": lambda: model.decode_fn(
                    params, fork, torch.zeros((FORK_N, 1), dtype=torch.long,
                                              device=params["embed"].device),
                    LM_PROMPT + LM_NEW - 1),
                "fork": fork_fn}
        for name, fn in runs.items():
            calls = max(1, math.ceil(DEVICE_WINDOW_MS / max(
                cuda_ms(fn, reps=1), 1e-3)))
            rows, wall = profile_rows(torch,
                                      lambda: [fn() for _ in range(calls)])
            busy = sum(ms for _, ms, _ in rows)
            out[name] = {"calls": calls, "wall_ms": wall / calls,
                         "device_ms": busy / calls, "busy_share": busy / wall,
                         "kernels": rows}
            say(f"phase 11 {name} profile ({calls} calls): wall "
                f"{wall / calls:.2f} ms, device busy {busy / calls:.2f} ms "
                f"({100 * busy / wall:.1f}%) per call; over all calls: "
                + ", ".join(f"{k[:48]} {ms:.3f} ms x{n}"
                            for k, ms, n in rows[:5]))
    return out


def phase_fork(torch, ops, dev, lm, model, params, prompts):
    """One prompt's cache forked FORK_N ways through ``rowclone_copy``,
    bit for bit against the tiled fork, then LM_NEW decode steps from
    each fork with identical logits."""
    _, _, engine_mod = lm
    cfg = model.cfg
    s_max = LM_PROMPT + LM_NEW
    engine = engine_mod.ServeEngine(model, params, s_max=s_max)
    with torch.no_grad():
        logits, cache = model.prefill_fn(params, {"tokens": prompts[:1]})
    cache = engine_mod.pad_cache_to(cache, s_max)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    fork = engine.fork_cache(cache, FORK_N)
    torch.cuda.synchronize()
    t_fork = time.perf_counter() - t0
    counts = ops.launches()
    n_leaves = sum(len(v) for v in cache.values())
    check(counts["rowclone_copy"] == n_leaves * FORK_N,
          f"the fork launched rowclone_copy {counts['rowclone_copy']} times, "
          f"not {n_leaves} x {FORK_N}")
    t1 = time.perf_counter()
    tiled = engine.fork_cache(cache, FORK_N, use_kernel=False)
    torch.cuda.synchronize()
    t_tile = time.perf_counter() - t1
    for pos in fork:
        for name in fork[pos]:
            a, b = fork[pos][name], tiled[pos][name]
            check(a.shape == b.shape and torch.equal(
                a.view(torch.int16), b.view(torch.int16)),
                f"fork {pos}.{name}: kernel copy != tiled copy")
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None].repeat(FORK_N, 1)
    with torch.no_grad():
        for t in range(LM_NEW):
            la, fork = model.decode_fn(params, fork, tok, LM_PROMPT + t)
            lb, tiled = model.decode_fn(params, tiled, tok, LM_PROMPT + t)
            check(torch.equal(la, lb), f"decode step {t}: logits from the "
                                       f"two forks differ")
            check(bool(torch.isfinite(la).all()), "non-finite decode logits")
            tok = la[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    leaf = cache["p0"]["k"]
    say(f"phase 10 fork: {FORK_N}-way fork of a {LM_PROMPT}-token cache "
        f"({n_leaves} leaves of {tuple(leaf.shape)} {leaf.dtype}) through "
        f"rowclone_copy, {counts['rowclone_copy']} launches, "
        f"{t_fork * 1e3:.2f} ms (tiled {t_tile * 1e3:.2f} ms), bit for bit "
        f"equal to the tiled fork; {LM_NEW} decode steps from each fork "
        f"with identical logits")
    return counts["rowclone_copy"], {"fork_ms": t_fork * 1e3,
                                     "tiled_ms": t_tile * 1e3,
                                     "leaf_shape": list(leaf.shape)}, cache, \
        fork


def sdpa_call(torch, q, k, v, causal):
    """``scaled_dot_product_attention`` on the kernel's flattened inputs,
    query head i over kv head i // G (its ``enable_gqa`` grouping)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          is_causal=causal,
                                          enable_gqa=True)[0]


def phase_lm_timing(torch, ops, ref, rec, cache, flash_launches,
                    rowclone_launches):
    """Each LM kernel's time at the serving path's shapes: flash on the
    first prefill layer's inputs, rowclone on one fork copy of a cache
    leaf into its slot, timed in turns with ``clone`` of the same leaf;
    device ms per launch over a profiled window of back-to-back calls."""
    out = []
    q, k, v, causal = rec.flash_args
    kern = rec.orig[2]
    got, want = kern(q, k, v, causal), ref.flash_attention_ref(q, k, v, causal)
    ok, err = close(got, want, FLASH_TOL["float32"], FLASH_TOL["float32"])
    check(ok, f"flash_attention != plain on the prefill's inputs "
              f"(max abs err {err})")
    BH, S, hd = q.shape
    lib = sdpa_call(torch, q, k, v, causal)
    lib_err = float((lib - want).abs().max())
    nbytes = 2 * q.numel() * q.element_size() \
        + (k.numel() + v.numel()) * k.element_size()
    nops = (2 if causal else 4) * BH * S * k.shape[1] * hd
    # the kernel runs each product as 3xTF32 on the tensor cores (two
    # products for bf16 K / V); the fp32 SIMT bound is printed beside it
    products = 3 if k.dtype == torch.float32 else 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * nops / TF32_OPS_PER_S * 1e3
    bms, bby = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")
    simt_ms, _ = bound_ms(nbytes, nops)
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": flash_launches,
        "max_abs_err": err, "ms": cuda_ms(lambda: kern(q, k, v, causal),
                                          reps=10),
        "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal),
                            reps=3),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: sdpa_call(torch, q, k, v, causal),
                              reps=10),
        **device_fields(lambda: kern(q, k, v, causal),
                        "flash_attention_kernel"),
        "library_max_abs_err": lib_err,
        "bound": f"{products}xTF32 tensor-core operations at "
                 f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s",
        "bound_fp32_simt_ms": simt_ms,
        "shape": f"q {list(q.shape)}, k/v {list(k.shape)} {q.dtype}, "
                 f"causal={causal} (one prefill layer)",
        "flops": nops})
    x = cache["p0"]["k"]
    flat = x.reshape(x.shape[0], -1)
    wide = torch.empty((x.shape[0], FORK_N, flat.shape[1]), dtype=x.dtype,
                       device=x.device)
    slot = wide[:, 1]
    copy = rec.ops.rowclone_copy
    copy(flat, out=slot)
    err = 0.0 if torch.equal(slot.view(torch.int16),
                             flat.view(torch.int16)) else float("inf")
    check(err == 0, "rowclone_copy != its input on a fork leaf")
    nbytes = 2 * flat.numel() * flat.element_size()
    bms, bby = bound_ms(nbytes, 0)
    turns = turns_ms({"kernel": lambda: copy(flat, out=slot),
                      "clone": lambda: flat.clone()}, reps=20)
    out.append({
        "name": "rowclone_copy", "route": "cuda",
        "source": SOURCES["rowclone_copy"],
        "replaces": REPLACES["rowclone_copy"], "launches": rowclone_launches,
        "max_abs_err": err,
        "ms": sum(turns["kernel"]) / len(turns["kernel"]),
        "plain_ms": cuda_ms(lambda: ref.rowclone_copy_ref(flat, out=slot),
                            reps=20),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": sum(turns["clone"]) / len(turns["clone"]),
        "turns_ms": turns,
        **device_fields(lambda: copy(flat, out=slot), "rowclone_copy_kernel"),
        "library_device_ms": device_ms(lambda: flat.clone()),
        "shape": f"{list(flat.shape)} {flat.dtype} into slot 1 of "
                 f"{list(wide.shape)} (one fork copy of a cache leaf)",
        "bytes": nbytes})
    say("phase 12 LM kernels: " + ", ".join(
        f"{k['name']} {k['launches']} launches, {k['ms']:.4f} ms per call, "
        f"device {k['device_ms']} ms (plain {k['plain_ms']:.4f} ms, library "
        f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
        f"{k['bound_by']}"
        + (f", fp32 SIMT bound {k['bound_fp32_simt_ms']:.4f} ms"
           if "bound_fp32_simt_ms" in k else "") + ")" for k in out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import (bloom as bloom_mod, cachesim, campaign,
                                      dram, emulator as emu, faults,
                                      smcprog, techniques, timescale, traces)
        from repro_torch import configs
        from repro_torch.kernels import ops, ref
        from repro_torch.models import model_zoo
        from repro_torch.serve import engine as engine_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    geo = timescale.JETSON_NANO.geometry
    rec = Recorder(ops, ref, dram.NOP, emu.BIG)
    report = {"device": torch.cuda.get_device_name(0)}
    try:
        t0 = time.perf_counter()
        ops.library()
        info = dict(ops.BUILD_INFO)
        say(f"phase 1 build: {len(set(SOURCES.values()))} kernel sources "
            f"with nvcc for sm_90a in "
            f"{time.perf_counter() - t0:.1f} s")
        for ln in info.get("ptxas", []):
            say(f"  ptxas: {ln}")
        report["build"] = info
        phase_bloom(torch, np, ops, ref, dev, bloom_mod, techniques, timescale)
        vm_args = phase_policy(torch, np, ops, ref, dev, smcprog)
        report["scan_check_s"] = phase_scan(
            np, rec, emu, techniques, timescale, traces, smcprog, geo, dev)
        report["wide"] = phase_wide(np, torch, ops, ref, emu, smcprog,
                                    timescale, vm_args[1], dev)
        counts, report["main"], slower_buckets = phase_main(
            np, torch, ops, rec, emu, techniques, timescale, traces, campaign,
            smcprog, geo, dev)
        for name in PATH_KERNELS:
            check(counts[name] > 0, f"{name} was not launched on the main "
                                    f"path")
        check(any(g["args"][-1].table_len > 0 for g in rec.groups),
              "no main-path slot_scan group ran the policy VM")
        kernels = phase_timing(torch, ops, ref, rec, counts, vm_args)
        scan = next(k for k in kernels if k["name"] == "slot_scan")
        scan["all_launches"] = scan_totals(torch, rec,
                                           report["main"]["wall_s"])
        say("phase 6 kernels: " + ", ".join(
            f"{k['name']} {k['launches']} launches, {k['ms']:.4f} ms per "
            f"call, device {k['device_ms']:.5f} ms per launch (plain "
            f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.5f} ms)"
            for k in kernels))
        err, report["plain_groups"] = phase_plain_groups(np, rec,
                                                         slower_buckets)
        scan["max_abs_err"] = max(scan["max_abs_err"], float(err))
        scan["plain_groups"] = report["plain_groups"]
        err, report["faults"] = phase_faults(
            np, torch, ops, ref, emu, techniques, timescale, traces, faults)
        scan["max_abs_err"] = max(scan["max_abs_err"], float(err))
        scan["faults"] = report["faults"]
        err, window_entry, report["stream"] = phase_stream(
            np, torch, ops, ref, emu, smcprog, timescale, traces, faults,
            cachesim, campaign)
        window_entry["max_abs_err"] = float(err)
        kernels.append(window_entry)

        lm = (configs, model_zoo, engine_mod)
        report["flash_grid_err"] = phase_lm_kernels(torch, ops, ref, dev)
        flash_n, report["serve"], model, params, prompts, lm_rec = \
            phase_serve(torch, np, ops, ref, dev, lm)
        rc_n, report["fork"], cache1, fork = phase_fork(
            torch, ops, dev, lm, model, params, prompts)
        fork_engine = engine_mod.ServeEngine(model, params, model.s_max)
        report["profile"] = phase_profile(
            torch, model, params, prompts, fork,
            lambda: fork_engine.fork_cache(cache1, FORK_N))
        kernels += phase_lm_timing(torch, ops, ref, lm_rec, cache1, flash_n,
                                   rc_n)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        rec.restore()
    report["kernels"] = kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    report["nvidia_smi"] = smi
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
