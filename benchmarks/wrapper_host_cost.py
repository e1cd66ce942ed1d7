#!/usr/bin/env python3
"""The host work of one ``bloom_probe`` call of the port, piece by piece.

Usage (from the repository root, on a machine with an NVIDIA GPU and
``nvcc``)::

    python3 benchmarks/wrapper_host_cost.py

At the main path's shape (words ``[1, 32768]``, keys ``[16, 16384]``,
k = 4), each line is microseconds of host time per call over 20000
back-to-back calls (``time.perf_counter``; the card runs behind): the
entry point ``ops.bloom_probe``, the wrapper ``bloom_probe_cuda``, the C
launch alone through ctypes, and each step the wrapper takes, beside the
alternatives it was chosen over (``torch.empty`` against
``torch.empty_like``, ``torch.cuda.current_stream`` against the raw
stream). The card's name and power limit are printed first; the last
line is a JSON object of all the numbers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20000


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("wrapper_host_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels.bloom_probe import bloom_probe_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", torch.cuda.current_device())
    lib = ops.library()
    g = torch.Generator(device=dev).manual_seed(0)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, 32768), generator=g,
                          dtype=torch.int32, device=dev)
    keys = torch.randint(0, 1 << 19, (16, 16384), generator=g,
                         dtype=torch.int32, device=dev)
    out = torch.empty_like(keys, dtype=torch.int8)
    k, m_bits = 4, 1 << 20
    handle = ops.stream_handle(dev)
    wp, kp, op = words.data_ptr(), keys.data_ptr(), out.data_ptr()
    pieces = {
        "ops.bloom_probe": lambda: ops.bloom_probe(words, keys, k, m_bits),
        "bloom_probe_cuda": lambda: bloom_probe_cuda(words, keys, k, m_bits),
        "C launch through ctypes": lambda: lib.bloom_probe_launch(
            wp, 1, 32768, kp, op, 16, 16384, k, m_bits, handle),
        "torch.empty(shape, dtype, device)": lambda: torch.empty(
            keys.shape, dtype=torch.int8, device=dev),
        "torch.empty_like(keys, dtype)": lambda: torch.empty_like(
            keys, dtype=torch.int8),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ops.stream_handle(dev)": lambda: ops.stream_handle(dev),
        "device, dtype, dim and contiguity checks": lambda: (
            keys.device.type != "cuda" or words.device != keys.device
            or words.dtype != torch.int32 or keys.dtype != torch.int32
            or words.dim() != 2 or keys.dim() != 2
            or not words.is_contiguous() or not keys.is_contiguous()),
        "ops.aligned16(keys)": lambda: ops.aligned16(keys),
        "ops.check_launch": lambda: ops.check_launch("bloom_probe", 0),
    }
    us = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        us[name] = (time.perf_counter() - t0) / CALLS * 1e6
        torch.cuda.synchronize()
        print(f"{name:45s} {us[name]:8.3f} us per call", flush=True)
    print(json.dumps({"card": smi, "calls": CALLS, "us_per_call": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
