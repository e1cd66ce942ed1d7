#!/usr/bin/env python3
"""The port's ``slot_scan``, ``bloom_probe``, ``policy_vm`` and
``rowclone_copy`` kernels against another checkout's, on the same card and
the same inputs, in one process.

Usage (from the repository root, on a machine with an NVIDIA GPU and
``nvcc``)::

    python3 benchmarks/port_kernel_ab.py --base /path/to/other/checkout

``--base`` is a directory holding the other checkout's
``src/repro_torch`` (for example ``git archive <commit> | tar -x -C
build/base``). Both sides' kernels are built with the port's nvcc flags;
each side's ``-Xptxas -v`` frame (registers, stack) is printed. Then:

- ``slot_scan`` on the main path's own groups (the RowClone 4 MiB copy
  study, four PolyBench traces in ``ts`` mode, the built-in policy
  sweep) and on ``chip_smoke.py`` phase 7b's two full-size fault groups
  (the RowHammer study's 16 x 131072 policy group and its storms as a
  legacy group with the fault model), recorded through the engine's
  entry points: every output field of the two sides must be equal, the
  fault fields included, and each group is timed on both (CUDA events
  over back-to-back launches spanning at least 10 ms a turn,
  ``--scan-rounds`` rounds of base, port, port, base): the median and
  the spread of each side's ns per slot;
- ``bloom_probe`` at the main path's shape (the paper's 2^20-bit, k = 4
  filter over 16 x 16384 row ids) and the batch ``policy_vm`` at
  ``chip_smoke.py`` phase 3's bucket-16 tables (137 x 64 lanes): both
  sides' outputs equal, then each side's device time per launch
  (profiler, 200 launches a turn), in turns (the port through its entry
  point, the base through its C launch);
- ``bloom_probe`` per call through each checkout's own Python wrapper
  (``kernels/bloom_probe.py`` with its ``kernels/ops.py`` helpers) and C
  launch, both loaded into this process the same way, which is what the
  engine waits for:
  ``--wrapper-rounds`` rounds of base, port, port, base, 2000 calls a
  turn (CUDA events); both outputs equal;
- ``rowclone_copy`` on one fork copy of a qwen3-8b cache leaf
  (``[36, 1064960]`` bf16 into slot 1 of ``[36, 4, 1064960]``): both
  sides bit for bit, then both and ``clone`` of the leaf timed in turns
  (CUDA events, 50 calls a turn, 4 turns).

The last line is a JSON summary. Exits non-zero if any output differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("slot_scan", "bloom_probe", "policy_vm", "rowclone_copy")
FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
          "smc_fpga_cycles", "t_resp", "t_issue")
FAULT_FIELDS = ("flips", "ham_flips", "ret_flips", "mitigations",
                "victim_bank", "victim_row", "victim_t")


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compile_side(ops, checkout, out_dir):
    """A checkout's two kernels compiled with the port's flags: the object
    files and the compiler's frame lines (registers, stack) per source."""
    csrc = os.path.join(checkout, "src", "repro_torch", "kernels", "csrc")
    os.makedirs(out_dir, exist_ok=True)
    objs, frames = [], {}
    for name in KERNELS:
        obj = os.path.join(out_dir, name + ".o")
        r = subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-c",
                            os.path.join(csrc, name + ".cu"), "-o", obj],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {csrc}/{name}.cu:\n"
                               f"{r.stderr}")
        frames[name] = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                        if "registers" in ln or "stack" in ln]
        objs.append(obj)
    return objs, frames


def build_base(ops, base, out_dir):
    """The base checkout's four kernels in one shared library; returns it
    and their frame lines."""
    objs, frames = compile_side(ops, base, out_dir)
    so = os.path.join(out_dir, "libbase.so")
    subprocess.run([ops._nvcc(), "-shared", "-o", so, *objs], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    # the base's slot_scan_launch: params, 8 inputs, 5 outputs (t_issue,
    # t_resp, stats, and the fault counters and log, null without a fault
    # model), the stream
    lib.slot_scan_launch.argtypes = [ctypes.POINTER(ctypes.c_int)] \
        + [vp] * 14
    lib.slot_scan_launch.restype = ctypes.c_int
    lib.rowclone_copy_launch.argtypes = [vp, vp, ll, ll, ll, vp]
    lib.rowclone_copy_launch.restype = ctypes.c_int
    i = ctypes.c_int
    lib.bloom_probe_launch.argtypes = [vp, i, i, vp, vp, i, i, i, i, vp]
    lib.bloom_probe_launch.restype = i
    lib.policy_vm_launch.argtypes = [vp, i, i, vp, i, vp, vp]
    lib.policy_vm_launch.restype = i
    return lib, frames


def device_ms(torch, fn, name, reps):
    """Device ms per launch of the kernels whose name holds ``name``
    (profiler) over ``reps`` calls of ``fn``, and the launches seen."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            us += getattr(ev, "device_time_total",
                          getattr(ev, "cuda_time_total", 0.0))
            n += ev.count
    return (us / 1e3 / n if n else float("nan")), n


def bloom_inputs(torch, dev):
    """The main path's ``bloom_probe`` shape, from the importable package:
    the tRCD study's filter as words ``[1, 32768]``, 16 x 16384 seeded
    row ids, k and m_bits."""
    import numpy as np
    from repro_torch.core import techniques, timescale
    from repro_torch.core.bloom import words_tensor
    jn = timescale.JETSON_NANO
    bf = techniques.TRCDReduction(jn).characterize()
    geo = jn.geometry
    words = words_tensor(bf.bits, dev).unsqueeze(0).contiguous()
    rng = np.random.RandomState(0)
    keys = torch.from_numpy(rng.randint(0, geo.n_banks * geo.n_rows,
                                        (16, 16384)).astype(np.int32)).to(dev)
    return words, keys, bf.k, bf.m_bits


def checkout_wrapper(checkout, lib):
    """``bloom_probe_cuda`` as the checkout ``checkout`` defines it, with
    that checkout's own ``kernels/ops.py`` helpers, ``library()``
    returning ``lib``: its Python wrapper and C launch, loaded beside the
    port's in one process (each file run under a name of its own)."""
    import builtins
    import types
    kdir = os.path.join(checkout, "src", "repro_torch", "kernels")

    def load(name, ns):
        path = os.path.join(kdir, name)
        ns.update(__file__=path, __name__="ab_" + os.path.basename(
            os.path.abspath(checkout)) + "_" + name[:-3])
        with open(path) as fh:
            exec(compile(fh.read(), path, "exec"), ns)
        return ns
    shim = types.SimpleNamespace(**load("ops.py", {}))
    shim.library = lambda: lib
    pkg = types.SimpleNamespace(ops=shim)
    real_import = builtins.__import__

    def imp(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch.kernels" and fromlist:
            return pkg
        return real_import(name, globals, locals, fromlist, level)
    ns = {"__builtins__": {**vars(builtins), "__import__": imp}}
    return load("bloom_probe.py", ns)["bloom_probe_cuda"]


def wrapper_turns(torch, dev, ops, lib, base, rounds, summary):
    """``bloom_probe`` per call through each checkout's own wrapper and C
    launch at the main path's shape, both loaded the same way
    (:func:`checkout_wrapper`), ``rounds`` rounds of base, port, port,
    base, 2000 calls a turn (CUDA events). Returns whether both outputs
    were equal."""
    words, keys, k, m_bits = bloom_inputs(torch, dev)
    fns = {"base": checkout_wrapper(base, lib),
           "port": checkout_wrapper(ROOT, ops.library())}
    outs = {side: fn(words, keys, k, m_bits) for side, fn in fns.items()}
    same = torch.equal(outs["base"], outs["port"])
    ms = {"base": [], "port": []}
    for _ in range(rounds):
        for side in ("base", "port", "port", "base"):
            ms[side].append(cuda_ms(torch, lambda: fns[side](
                words, keys, k, m_bits), 2000))
    med = {side: statistics.median(v) for side, v in ms.items()}
    summary["bloom_probe_per_call"] = {"equal": same, "ms": ms,
                                       "median_ms": med}
    print(f"bloom_probe per call, each checkout's wrapper and C launch: "
          f"equal {same}; " + "; ".join(
              f"{side} median {med[side]:.5f} ms ({min(v):.5f}-"
              f"{max(v):.5f}, {len(v)} turns)" for side, v in ms.items()))
    return same


def small_kernels(torch, dev, ops, lib, summary):
    """bloom_probe and the batch policy_vm, both sides on the same inputs:
    outputs equal, then device ms per launch in turns.
    Returns whether every output was equal."""
    import numpy as np
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.core import smcprog
    words, keys, k, m_bits = bloom_inputs(torch, dev)
    base_out = torch.empty(keys.shape, dtype=torch.int8, device=dev)

    def base_bloom():
        err = lib.bloom_probe_launch(
            words.data_ptr(), 1, words.shape[1], keys.data_ptr(),
            base_out.data_ptr(), keys.shape[0], keys.shape[1], k, m_bits,
            ops.stream_handle(dev))
        if err:
            raise RuntimeError(f"base bloom_probe launch failed: {err}")
        return base_out

    # phase 3's bucket-16 group of chip_smoke.py
    vrng = np.random.RandomState(0)
    q = 64
    env = vrng.randint(0, 64, (smcprog.N_LOADS, q)).astype(np.int64)
    env[0] = vrng.randint(2 ** 30, 2 ** 31, q)
    env[1] = vrng.randint(-2 ** 31, 2 ** 31, q)
    env[7] = vrng.randint(-40, 16, q)
    env[:, q // 2:] = vrng.randint(-2 ** 31, 2 ** 31,
                                   (smcprog.N_LOADS, q - q // 2))
    envm = torch.from_numpy(env.astype(np.int32)).to(dev)
    progs = list(smcprog.builtin_programs().values()) \
        + list(smcprog.mitigation_programs().values())
    pool = [p for p in progs if smcprog.table_bucket(p.n_ops) <= 16]
    pool += [chip_smoke.random_table(vrng, 16, f"r16_{i}", smcprog)
             for i in range(128)]
    tables = torch.from_numpy(smcprog.pack_stack(pool, 16)).to(dev)
    P, L = tables.shape[0], tables.shape[1] - 1
    base_vm = torch.empty((P, 3, q), dtype=torch.int32, device=dev)

    def base_policy():
        err = lib.policy_vm_launch(tables.data_ptr(), P, L, envm.data_ptr(),
                                   q, base_vm.data_ptr(),
                                   ops.stream_handle(dev))
        if err:
            raise RuntimeError(f"base policy_vm launch failed: {err}")
        return base_vm

    cases = {
        "bloom_probe": {
            "port": lambda: ops.bloom_probe(words, keys, k, m_bits),
            "base": base_bloom},
        "policy_vm": {"port": lambda: ops.policy_vm(tables, envm),
                      "base": base_policy},
    }
    ok = True
    for name, fns in cases.items():
        outs = {side: fn().clone() for side, fn in fns.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(o, outs["base"]) for o in outs.values())
        ok = ok and same
        turns = {side: {"device_ms": []} for side in fns}
        order = list(fns) + list(fns)[::-1]
        for side in order:
            dms, _ = device_ms(torch, fns[side], f"{name}_kernel", 200)
            turns[side]["device_ms"].append(dms)
        summary[name] = {"equal": same, "shape": (
            f"words {list(words.shape)}, keys {list(keys.shape)}, k {k}"
            if name == "bloom_probe" else
            f"tables {list(tables.shape)}, env {list(envm.shape)}"),
            "turns": turns}
        print(f"{name}: equal {same}; " + "; ".join(
            f"{side} device " + " ".join(f"{v:.5f}" for v in t["device_ms"])
            + " ms per launch" for side, t in turns.items()))
    return ok


def record_groups(torch, dev, ops):
    """Every slot_scan group of a reduced main path, with its outputs."""
    from repro_torch.core import (emulator as emu, smcprog, techniques,
                                  timescale, traces)
    groups, tag = [], [""]
    orig = ops.slot_scan

    def rec(*args):
        out = orig(*args)
        groups.append((tag[0], args, out))
        return out
    ops.slot_scan = rec
    try:
        jn = timescale.JETSON_NANO
        sys.path.insert(0, ROOT)
        import chip_smoke
        from repro_torch.core import faults
        fm = faults.FaultModel(**chip_smoke.STUDY_FM)
        tag[0] = "faults-study"
        techniques.RowHammerMitigationStudy(jn, fault_model=fm).evaluate(
            chip_smoke.STUDY_INTENSITIES,
            n_requests=chip_smoke.STUDY_REQUESTS, device=dev)
        tag[0] = "faults-legacy"
        emu.run_many([traces.rowhammer_trace(
            chip_smoke.STUDY_REQUESTS, jn.geometry, intensity=x, seed=i)
            for i, x in enumerate(chip_smoke.STUDY_INTENSITIES)],
            jn.with_faults(fm), device=dev)
        tag[0] = "rowclone-copy"
        techniques.RowClone(jn).evaluate_batch([4 << 20], workload="copy",
                                               device=dev)
        trs = [traces.polybench_trace(k, jn.geometry)[0]
               for k in traces.POLYBENCH[:4]]
        tag[0] = "polybench-ts"
        emu.run_many(trs, jn, "ts", device=dev)
        tag[0] = "policies"
        emu.run_policies(trs[0], jn,
                         list(smcprog.builtin_programs().values()),
                         device=dev)
    finally:
        ops.slot_scan = orig
    return groups


def base_scan(torch, ops, lib, args):
    p = args[-1]
    shape = (p.batch, p.n)
    dev = args[0].device
    t_issue = torch.zeros(shape, dtype=torch.int32, device=dev)
    t_resp = torch.full(shape, 2 ** 30, dtype=torch.int32, device=dev)
    stats = torch.zeros((p.batch, 5), dtype=torch.int32, device=dev)
    fstats = vlog = None
    if p.victim_slots > 0:
        fstats = torch.zeros((p.batch, 4), dtype=torch.int32, device=dev)
        vlog = torch.full((p.batch, 3, p.victim_slots), -1,
                          dtype=torch.int32, device=dev)
    params = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
    outs = [ops.ptr(t) for t in (t_issue, t_resp, stats, fstats, vlog)]
    err = lib.slot_scan_launch(params, *[ops.ptr(a) for a in args[:8]],
                               *outs, ops.stream_handle(dev))
    if err:
        raise RuntimeError(f"base slot_scan launch failed: {err}")
    out = {f: stats[:, i] for i, f in enumerate(FIELDS[:5])}
    out.update(t_resp=t_resp, t_issue=t_issue)
    if fstats is not None:
        out.update({f: fstats[:, i] for i, f in enumerate(FAULT_FIELDS[:4])})
        out.update({f: vlog[:, i] for i, f in enumerate(FAULT_FIELDS[4:])})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="directory of the other checkout")
    ap.add_argument("--scan-rounds", type=int, default=5,
                    help="rounds of base, port, port, base per scan group")
    ap.add_argument("--wrapper-rounds", type=int, default=10,
                    help="rounds of base, port, port, base of the "
                         "bloom_probe wrappers")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("port_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    ops.library()
    out_dir = os.path.join(ROOT, "build", "port_ab")
    lib, base_frames = build_base(ops, args.base,
                                  os.path.join(out_dir, "base"))
    _, port_frames = compile_side(ops, ROOT, os.path.join(out_dir, "port"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    print(f"port frames: {port_frames}")
    print(f"base frames: {base_frames}")
    summary = {"card": smi, "base_frames": base_frames,
               "port_frames": port_frames,
               "scan": [], "rowclone": {}}
    ok = True
    for tag, a, got in record_groups(torch, dev, ops):
        p = a[-1]
        want = base_scan(torch, ops, lib, a)
        torch.cuda.synchronize()
        same = set(got) == set(want) and all(
            torch.equal(got[f], want[f]) for f in want)
        ok = ok and same
        fns = {"port": lambda: ops.slot_scan(*a),
               "base": lambda: base_scan(torch, ops, lib, a)}
        # back-to-back launches spanning >= 10 ms a turn, so that a small
        # group's time is the device's, not the host's launch work
        reps = max(1, math.ceil(10.0 / cuda_ms(torch, fns["port"], 1)))
        ns = {"port": [], "base": []}
        for _ in range(args.scan_rounds):
            for side in ("base", "port", "port", "base"):
                ns[side].append(cuda_ms(torch, fns[side], reps) * 1e6
                                / p.slots)
        row = {"tag": tag, "batch": p.batch, "n": p.n, "slots": p.slots,
               "table_len": p.table_len, "equal": same, "ns_per_slot": ns,
               **{f"{side}_ns_per_slot": statistics.median(v)
                  for side, v in ns.items()}}
        row["median_ratio"] = row["port_ns_per_slot"] / row["base_ns_per_slot"]
        summary["scan"].append(row)
        print(f"slot_scan {tag} {p.batch} x {p.n}, {p.slots} slots: equal "
              f"{same}; port {row['port_ns_per_slot']:.1f} ns/slot "
              f"({min(ns['port']):.1f}-{max(ns['port']):.1f}), base "
              f"{row['base_ns_per_slot']:.1f} ({min(ns['base']):.1f}-"
              f"{max(ns['base']):.1f}), median ratio "
              f"{row['median_ratio']:.4f} over {len(ns['port'])} turns of "
              f"{reps} launches a side")

    ok = small_kernels(torch, dev, ops, lib, summary) and ok
    ok = wrapper_turns(torch, dev, ops, lib, args.base, args.wrapper_rounds,
                       summary) and ok

    R, C = 36, 1064960
    x = torch.randn((R, C), device=dev).to(torch.bfloat16)
    wide = torch.zeros((R, 4, C), dtype=torch.bfloat16, device=dev)
    slot = wide[:, 1]

    def base_copy():
        err = lib.rowclone_copy_launch(x.data_ptr(), slot.data_ptr(), R,
                                       C * 2, 4 * C * 2,
                                       ops.stream_handle(dev))
        if err:
            raise RuntimeError(f"base rowclone_copy launch failed: {err}")
    fns = {"port": lambda: ops.rowclone_copy(x, out=slot),
           "base": base_copy, "clone": lambda: x.clone()}
    for name in ("port", "base"):
        slot.zero_()
        fns[name]()
        torch.cuda.synchronize()
        same = torch.equal(slot.view(torch.int16), x.view(torch.int16))
        ok = ok and same
        summary["rowclone"][f"{name}_exact"] = same
    turns = {k: [] for k in fns}
    for _ in range(4):
        for k, fn in fns.items():
            turns[k].append(cuda_ms(torch, fn, 50))
    summary["rowclone"]["turns_ms"] = turns
    print("rowclone_copy fork leaf, ms per call in turns: " + "; ".join(
        f"{k} {' '.join(f'{v:.5f}' for v in vs)}" for k, vs in turns.items()))
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
