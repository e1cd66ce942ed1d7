#!/usr/bin/env python3
"""The port's ``slot_scan`` and ``rowclone_copy`` kernels against another
checkout's, on the same card and the same inputs, in one process.

Usage (from the repository root, on a machine with an NVIDIA GPU and
``nvcc``)::

    python3 benchmarks/port_kernel_ab.py --base /path/to/other/checkout

``--base`` is a directory holding the other checkout's
``src/repro_torch`` (for example ``git archive <commit> | tar -x -C
build/base``). Both sides' kernels are built with the port's nvcc flags;
each side's ``-Xptxas -v`` frame (registers, stack) is printed. Then:

- ``slot_scan`` on the main path's own groups (the RowClone 4 MiB copy
  study, four PolyBench traces in ``ts`` mode, the built-in policy
  sweep), recorded through the engine's entry points: every output field
  of the two sides must be equal, and each group is timed on both (CUDA
  events, one launch each, in turns);
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
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
          "smc_fpga_cycles", "t_resp", "t_issue")


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
    for name in ("slot_scan", "rowclone_copy"):
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
    """The base checkout's two kernels in one shared library; returns it
    and their frame lines."""
    objs, frames = compile_side(ops, base, out_dir)
    so = os.path.join(out_dir, "libbase.so")
    subprocess.run([ops._nvcc(), "-shared", "-o", so, *objs], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.slot_scan_launch.argtypes = [ctypes.POINTER(ctypes.c_int)] + [vp] * 12
    lib.slot_scan_launch.restype = ctypes.c_int
    lib.rowclone_copy_launch.argtypes = [vp, vp, ll, ll, ll, vp]
    lib.rowclone_copy_launch.restype = ctypes.c_int
    return lib, frames


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
    params = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
    err = lib.slot_scan_launch(params, *[ops.ptr(a) for a in args[:8]],
                               ops.ptr(t_issue), ops.ptr(t_resp),
                               ops.ptr(stats), ops.stream_handle(dev))
    if err:
        raise RuntimeError(f"base slot_scan launch failed: {err}")
    out = {f: stats[:, i] for i, f in enumerate(FIELDS[:5])}
    out.update(t_resp=t_resp, t_issue=t_issue)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="directory of the other checkout")
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
    lib, base_frames = build_base(ops, args.base, os.path.join(out_dir, "base"))
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
        same = all(torch.equal(got[f], want[f]) for f in FIELDS)
        ok = ok and same
        port_ms = cuda_ms(torch, lambda: ops.slot_scan(*a), 1)
        base_ms = cuda_ms(torch, lambda: base_scan(torch, ops, lib, a), 1)
        port_ms = (port_ms + cuda_ms(torch, lambda: ops.slot_scan(*a), 1)) / 2
        row = {"tag": tag, "batch": p.batch, "n": p.n, "slots": p.slots,
               "table_len": p.table_len, "equal": same, "port_ms": port_ms,
               "base_ms": base_ms,
               "port_ns_per_slot": port_ms * 1e6 / p.slots,
               "base_ns_per_slot": base_ms * 1e6 / p.slots}
        summary["scan"].append(row)
        print(f"slot_scan {tag} {p.batch} x {p.n}, {p.slots} slots: equal "
              f"{same}; port {row['port_ns_per_slot']:.1f} ns/slot, base "
              f"{row['base_ns_per_slot']:.1f} ns/slot")

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
