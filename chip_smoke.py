#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage (from the repository root, on a machine with an NVIDIA H100)::

    python3 chip_smoke.py

Phases, one line each:

1. build the CUDA kernels from the six sources in
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
   all seven fields; then all the groups in one overlapped executor call
   (wide groups of different shared-memory sizes side by side), equal to
   the serial runs; the batch ``policy_vm`` at a 512-row table against
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
7d. the campaign executor at the main path's size: phase 5's grid (tRCD
   arms and the reference mode, RowClone copy and init, the built-in
   policies: at least 12 groups) through ``Campaign.run`` serial and
   overlapped in turns, equal on every field with the same launches, the
   overlapped run on more than one CUDA stream, its device span beside the
   sum of its launches; the grid checkpointed and resumed (nothing
   launched, the same records) and with a poisoned group quarantined (the
   others exact); phase 7c's streams through the executor's window loop
   (next window assembled during the scan, copy-back one window behind)
   against a feeder-thread loop, the serial window loop and single-shot
   in turns, equal, with their requests/s and peak device memory (the
   executor's no more than the serial loop's); ``policysearch.search`` at
   its defaults on the first PolyBench trace, and at a 2048-request cut against the same
   search on the plain engine (a CPU worker process started with the
   script); ``SchedulingPolicyStudy`` over the twelve PolyBench traces and
   every built-in, ``policy_axis`` True and False equal;
7e. the sweep service over phase 7d's grid, the plan cache cleared and the
   launch counters reset just before it: three in-process clients
   (weights 1, 1, 2) submit it interleaved behind a long coalescing
   window, every record equal to the serial ``Campaign.run``, every group
   one dispatch, points of several clients sharing dispatches, the plan
   cache missing once a group and nothing on a second pass; timed runs at
   the default 4 ms window (a thread a client) in turns with
   ``Campaign.run`` overlapped: wall time, dispatches, points per
   dispatch, coalescing ratio, latency percentiles; ``python -m
   repro_torch.service --persistent-cache`` in a process of its own (its
   library loaded before its first dispatch): the RowClone and policy
   points over a socket, stats over the socket, a typed
   ``QueueFullError``; a drain-close with a checkpoint directory, then a
   new server on it and ``Campaign.run(checkpoint=...)``, neither
   launching anything;
7f. the reference engine and sharding: ``ref_scan`` through
   ``run_ref_many`` on seeded cut groups (``REF_CASES``: ts, nots and
   reference with a shared Bloom filter, a filter per trace, runtime and
   staged policies, PARA without a fault model, phase 7b's fault model,
   a window of 80 over 128 banks with a 512-row table) against its plain
   version in CPU workers on every field; ``run_ref_many`` over phase 5's
   inputs at full size (counters reset just before), equal to
   ``run_many`` on every field, with ``ref_scan``'s time and ns per slot
   beside ``slot_scan``'s on the same groups; phase 7d's grid under
   ``set_sharding('force')`` (and ``'auto'`` across cards where there is
   more than one) equal to the unsharded records, the plan cache missing
   once a group on the first pass and not at all on the second;
8. ``flash_attention`` and ``rowclone_copy`` against their plain
   versions on the reference kernel tests' grids;
9. the LM serving path at the full width of ``qwen3-8b`` (random float32
   weights from a seed, bf16 KV cache): a warm-up prefill, then
   ``ServeEngine.generate_batch`` over 4 prompts of 1024 tokens, 16 new
   tokens each, with the launch counters reset just before it (the
   prefill launches ``flash_attention`` once per layer; its logits equal
   the warm-up's bit for bit); the same generation with
   ``flash_attention`` swapped for its plain version holds the prefill
   logits, the cache and the greedy tokens;
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
   SIMT bound;
13. training (the serving model freed first): (b) qwen2-1.5b at full
   width and depth, fp32 masters, bf16 compute, remat, AdamW at lr 3e-4
   with warmup 10, 4 x 2048 ``SyntheticLM`` tokens (S > 1024: the
   checkpointed query blocks), 12 steps with the last 10 timed (step ms,
   tokens/s, peak memory, the share of the bf16 dense peak in model
   FLOPs), one profiled step (busy share, top device ops), microbatches 2
   against 1, one ``int8_wire`` step, the launch counters reset just
   before: no kernel launches (the flash kernel has no backward); a
   batch that does not fit is cut, never width or depth; (c) at
   ``launch.train``'s small preset, 3 steps + async save + restore + 3
   against 6 straight, the async save holding step 3 while later steps
   update in place; (d) ``python -m repro_torch.launch.train`` at the
   tiny preset, 30 steps with the loss falling, then resumed to 40 from
   step 25; (a) the small preset's 3 float32 steps against the port's
   CPU run (a worker process started after (b)) at the CPU tests'
   tolerances (the masters at a rule of their own, see TRAIN_MASTER_*;
   the elements past TRAIN_MASTER_LR_TOL named with their gradients, m
   and v on both sides), and 3 bf16 steps' losses within 1e-2;
14. the MoE family (training's state freed first): (a)
   granite-moe-1b-a400m at full width and depth served as phase 9
   (counters reset just before: one flash launch a layer), each layer's
   routing recorded on both routes: a token routed to other experts on
   the plain route must sit at a near-tie (``MOE_TIE_RTOL``), its row's
   later calls are then not compared, and the logits and cache of every
   row routed alike are held to phase 9's tolerances; the same prefill
   twice routes and computes bit for bit alike; flash at head dim 64 on
   the first layer's inputs; forked and profiled as phases 10 and 11;
   (b) qwen3-moe-30b-a3b at full width and 16 of its 48 layers served
   as (a); (c) granite-moe-1b-a400m trained as 13b (7 steps, the last 5
   timed; ``moe_aux`` / ``moe_z`` of the first and last; model FLOPs over
   the active parameters), two bf16 forwards routed bit for bit alike,
   no kernel launched. (a) and (b)'s flash and rowclone launches join the
   ``kernels`` line's counts;
15. the mamba hybrid (the MoE models freed first): (a) jamba-v0.1 at
   full width and one pattern period, 8 of its 32 layers (7 mamba, 1
   attention; 4 of the 8 MLPs 16-expert top-2 MoEs), served as phase
   14a: the prefill launches ``selective_scan`` once a mamba layer and
   flash once, the kernel route against the plain route (the kernels
   swapped for their plain versions) on routing, logits and the cache
   (k / v / conv at phase 9's tolerances, the float32 ``h`` at
   ``H_CACHE_TOL``), forked and profiled; (b) ``selective_scan`` against
   its plain version on ``SSM_CASES`` and on the prefill's own inputs,
   timed there; (c) one pattern period at ``launch.train``'s small widths
   with jamba's MoE and SSM, 4 x 512 tokens: 3 float32 steps on the card
   against a CPU process (started before phase 14) at 13a's rules, then
   bf16 steps timed, no kernel launched. (a)'s launches join the
   ``kernels`` line's counts.

Device ms per launch comes from a profiled window of back-to-back calls
at least ``DEVICE_WINDOW_MS`` long, or from CUDA events when the trace
shows no launch; each entry names its method.

The engine's entry points launch ``bloom_probe`` and ``slot_scan`` (a
stream, ``slot_scan``'s window entry, counted as ``slot_scan_window``;
``run_ref`` / ``run_ref_many``, ``ref_scan``), the serving engine
``flash_attention``, ``selective_scan`` (a mamba layer's prefill) and
``rowclone_copy``; the policy VM runs inside ``slot_scan`` (``csrc/policy_vm.cuh``) on every
decision of a policy group, so the batch ``policy_vm`` kernel is checked
and timed at phase 3's shapes and has no launches on the main path.
Training (phases 13, 14c and 15c) launches none of the kernels and adds
no entry to the ``kernels`` line.

Exits non-zero on any failed check. The last two lines are the card's
name and power limit, then ``{"ok": true, "device": {...}}``. Details go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import pickle
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
DEVICE_WINDOW_MS = 20.0       # least span of a profiled window (device_ms)
SCALAR_OPS_PER_S = 67e12      # H100 SXM non-tensor float32 rate (data sheet)
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 tensor-core rate (data sheet)
BF16_PEAK_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
REPLACES = {
    "bloom_probe": "src/repro/kernels/bloom_probe.py:21",
    "policy_vm": "src/repro/kernels/policy_vm.py:31",
    "slot_scan": "src/repro/core/emulator.py:531",
    "slot_scan_window": "src/repro/core/emulator.py:1645",
    "ref_scan": "src/repro/core/emulator.py:735",
    "flash_attention": "src/repro/kernels/flash_attention.py:21",
    "rowclone_copy": "src/repro/kernels/rowclone_copy.py:18",
    # the associative_scan inside mamba_seq's remat'd lax.scan (:106)
    "selective_scan": "src/repro/models/mamba.py:63",
}
# the window entry is slot_scan.cu's fourth instantiation flag (kStream)
SOURCES = {name: "src/repro_torch/kernels/csrc/"
                 f"{'slot_scan' if name == 'slot_scan_window' else name}.cu"
           for name in REPLACES}
FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
          "smc_fpga_cycles", "t_resp", "t_issue")
PATH_KERNELS = ("bloom_probe", "slot_scan")   # launched by the entry points
N_POLYBENCH = 12          # POLYBENCH[:12] at max_accesses=60000 (phase 5)
SCAN_ACCESSES = 500       # max_accesses of the phase-4 traces
PLAIN_SLOT_LIMIT = 32772  # slot budget of a full 16384-request group
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
# phase 7d: the policy search at a cut of the first PolyBench trace, held
# against the same search on the plain engine (a worker process started
# with the script), and its seed
SEARCH_CUT, SEARCH_SEED = 2048, 0
ROWCLONE_SIZES = (64 << 10, 1 << 20, 4 << 20)   # phases 5 and 7d
# phase 7e: the sweep service over phase 7d's grid: three clients and their
# weights; a coalescing window long enough for every submission to land
# before the first flush (the coalescing and checkpoint checks; the timed
# runs take the service's default of 4 ms); timed runs in turns with the
# Campaign; the standalone server's per-client bound
SERVICE_WEIGHTS = (1.0, 1.0, 2.0)
SERVICE_LONG_WINDOW_S = 0.25
SERVICE_TURNS = 2
SERVICE_MAX_PENDING = 32
# phase 7f and the card tests: the reference engine's cut groups (seeded,
# 24-300 requests a trace) held against its plain version on every field
REF_SEED = 11
REF_CASES = ("modes-bloom-shared", "bloom-per-trace", "runtime-policies",
             "staged-policy", "para-no-fault-model", "faults-legacy",
             "faults-policies", "wide-q80-banks128-table512")
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
# phase 13, training: (a) launch.train's small preset of TRAIN_ARCH, 8 x
# 128 tokens, 3 steps on the card and in a CPU process started after
# (b), float32 compute (TF32 off) at tests/test_torch_train.py's
# tolerances (loss and grad norm rtol, m and v of each leaf's largest;
# masters in units of the summed lr: every element within Adam's bound
# of 2, all but a TRAIN_MASTER_TAIL share within TRAIN_MASTER_LR_TOL:
# 27 M elements have a longer tail of noise-level gradients than the
# tests' 0.5 M: their v sits at Adam's eps, each printed by
# master_tail), bf16 losses within 1e-2; (b) the arch at
# full width and depth, TRAIN_BATCH x TRAIN_SEQ tokens (S > 1024 takes
# the checkpointed query blocks), TRAIN_STEPS steps of which the last
# TRAIN_TIMED are timed, microbatches 2 against 1 at the reference
# test's loss tolerance (tests/test_train_infra.py)
TRAIN_ARCH, TRAIN_SEED = "qwen2_1_5b", 0
TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ, TRAIN_SMALL_STEPS = 8, 128, 3
TRAIN_SMALL_OPT = dict(lr=3e-3, warmup=10, total_steps=100)  # launch.train's
TRAIN_F32_RTOL, TRAIN_MV_TOL, TRAIN_MASTER_LR_TOL = 1e-5, 1e-4, 1e-2
TRAIN_MASTER_BOUND, TRAIN_MASTER_TAIL = 2.0, 1e-4
TRAIN_BF16_LOSS_RTOL = 1e-2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_TIMED = 4, 2048, 12, 10
TRAIN_LR, TRAIN_WARMUP = 3e-4, 10
TRAIN_MB_LOSS_RTOL = 2e-2
# phase 14, MoE (training's state freed first): (a) MOE_ARCH at full
# width and depth served as phase 9 (LM_BATCH x LM_PROMPT tokens, LM_NEW
# new, the flash route against the plain route), forked FORK_N ways as
# phase 10 and profiled as phase 11; (b) MOE_BIG_ARCH at full width and
# MOE_BIG_LAYERS of its 48 layers (its ~122 GB of fp32 weights at full
# depth do not fit one card), served as (a); (c) MOE_ARCH trained as 13b,
# MOE_TRAIN_STEPS steps of which the last MOE_TRAIN_TIMED are timed. The
# routes may route a token differently only at a near-tie of its K-th and
# (K+1)-th probabilities, relative to the K-th: in the prefill within
# MOE_TIE_RTOL, or within twice the largest difference between the
# routes' probabilities at its row's tokens routed alike in that layer
# (the routes' differences compound over the layers; that difference
# must stay within LOGIT_TOL); in a decode step, whose routes run the
# same code and differ only through the bf16 cache, within CACHE_RTOL
MOE_ARCH, MOE_BIG_ARCH, MOE_BIG_LAYERS = ("granite_moe_1b_a400m",
                                          "qwen3_moe_30b_a3b", 16)
MOE_TRAIN_STEPS, MOE_TRAIN_TIMED = 7, 5
MOE_TIE_RTOL = 1e-5
# phase 15, the mamba hybrid (the MoE phase's models freed first): (a)
# HYBRID_ARCH at full width and HYBRID_LAYERS of its 32 layers, one
# pattern period (13.295 B fp32 parameters, 53.2 GB: the full depth's
# 51.57 B, 206 GB, do not fit one card), served as phase 14a; (b)
# selective_scan against its plain version on SSM_CASES (batch, tokens,
# d_inner, d_state: both d_states, batches 1 and 4, token counts that are
# no multiple of the kernel's 32-token tile, d_inner that leave a tail
# block, one token, and jamba's prefill) and on the prefill's inputs;
# (c) one pattern period at launch.train's small widths (the MoE's
# expert d_ff cut to the small d_ff; 16 experts top 2 and the SSM, chunk
# 256, kept), HYBRID_TRAIN_BATCH x HYBRID_TRAIN_SEQ tokens (two chunks a
# layer): TRAIN_SMALL_STEPS float32 steps against the CPU at 13a's rules,
# then HYBRID_BF16_STEPS bf16 steps timed
HYBRID_ARCH, HYBRID_LAYERS = "jamba_v0_1_52b", 8
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, HYBRID_BF16_STEPS = 4, 512, 4
SSM_CASES = [(1, 100, 200, 8), (4, 33, 1000, 16), (4, 300, 64, 8),
             (1, 1, 16, 16), (4, 1024, 8192, 16)]
# selective_scan vs plain, y and hT each within SSM_TOL of its largest
# magnitude: both run the float32 recurrence token by token, the kernel
# with fused multiply-adds, its own exp and y's N terms summed as a
# butterfly, and a rounding difference lives on in h for ~1/(1 - dA)
# tokens
SSM_TOL = 1e-4
# kernel vs plain on one attention call: the tolerances of
# tests/test_kernels.py (the kernel's online softmax sums in another order)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the whole prefill, kernel route vs plain route: 36 layers compound each
# layer's ~1e-6 relative attention difference through float32 matmuls;
# logits may differ by 1e-3 of their largest magnitude, each bf16 cache
# value by one bf16 ulp (2^-7 relative) plus 1e-4 of the leaf's largest
LOGIT_TOL = 1e-3
CACHE_RTOL, CACHE_ATOL = 2.0 ** -7, 1e-4
# a mamba layer's float32 state h after the prefill, kernel route vs
# plain route: within LOGIT_TOL of the leaf's largest magnitude, as the
# logits (the routes' float32 differences compound over the layers)
H_CACHE_TOL = LOGIT_TOL


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
        import threading
        self.ops, self.ref, self.nop, self.big = ops, ref, nop, big
        self.orig = {name: getattr(ops, name) for name in ops.KERNELS}
        self.bloom_args = None
        self.groups = []
        self.windows = []
        self.refs = []
        self.tag = ""
        # the executor's workers launch from several threads at once
        self.lock = threading.Lock()

    def record(self):
        import torch
        o = self.orig

        def bp(words, keys, k, m_bits):
            with self.lock:
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
            host = {f: v.cpu().numpy() for f, v in out.items()}
            with self.lock:
                self.groups.append({"tag": self.tag, "args": args,
                                    "out": host})
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
            with self.lock:
                self.windows.append({"tag": self.tag,
                                     "args": (st, kind) + tuple(rest),
                                     "out": out})
            return out

        def rs(*args):
            out = o["ref_scan"](*args)
            host = {f: v.cpu().numpy() for f, v in out.items()}
            with self.lock:
                self.refs.append({"tag": self.tag, "args": args,
                                  "out": host})
            return out

        self.ops.bloom_probe, self.ops.slot_scan = bp, ss
        self.ops.slot_scan_window = ssw
        self.ops.ref_scan = rs

    def plain(self):
        r = self.ref
        self.ops.bloom_probe = r.bloom_probe_ref
        self.ops.slot_scan = r.slot_scan_ref
        self.ops.slot_scan_window = r.slot_scan_window_ref
        self.ops.ref_scan = r.ref_scan_ref
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
        ("modes", lambda **kw: emu.run_many(
            trs * 3, jn, ["ts"] * 4 + ["reference"] * 4 + ["nots"] * 4,
            device=dev, **kw)),
        ("fcfs", lambda **kw: emu.run_many(
            trs, dataclasses.replace(jn, scheduler="fcfs"), "nots",
            device=dev, **kw)),
        ("staged", lambda **kw: emu.run_many(
            trs, jn.with_policy(smcprog.bank_round_robin_program()), "nots",
            device=dev, **kw)),
        ("policies", lambda **kw: emu.run_policies(
            trs[0], jn, builtins, mode="nots", device=dev, **kw)),
        ("shared-bloom", lambda **kw: emu.run_many(
            trs, jn, "ts", blooms=bl, device=dev, **kw)),
        ("per-trace-bloom", lambda **kw: emu.run_many(
            trs, jn, "ts", blooms=[bl, bl2, bl, bl2], device=dev, **kw)),
    ]
    times = {}
    for label, fn in cases:
        rec.restore()
        t1 = time.perf_counter()
        got = fn()
        t2 = time.perf_counter()
        rec.plain()
        # the plain engine is ~1e3 small launches a slot from Python: in
        # the executor's threads they would contend for the GIL
        want = fn(serial=True)
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
    from repro_torch.core import executor
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
    serial = {}
    for name, sys_, tr, progs in cases:
        rec.tag = name
        if progs:
            serial[name] = emu.run_policies(tr, sys_, progs, mode="nots")
        else:
            serial[name] = [emu.run(tr, sys_, mode)
                            for mode in ("ts", "nots")]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, variants = ops.launches(), ops.variants()
    rec.restore()
    groups = rec.groups
    check(counts["slot_scan"] == len(groups) == sum(variants.values())
          and all(k.startswith("slot_scan/wide") for k in variants),
          f"phase 4b: {len(groups)} groups, launches {counts}, "
          f"instantiations {variants}")
    # every group again in one overlapped executor call: wide groups of
    # different shared-memory sizes launch side by side on the workers'
    # streams, each equal to its serial (plain-checked) run
    overlapped, tasks = {}, []
    for name, sys_, tr, progs in cases:
        overlapped[name] = [None] * len(serial[name])
        if progs:
            tasks += emu.prepare_tasks(
                [tr] * len(progs), sys_, "nots", None, overlapped[name],
                policies=progs, policy_costs=[p.smc_cycles() for p in progs])
        else:
            tasks += emu.prepare_tasks([tr, tr], sys_, ["ts", "nots"], None,
                                       overlapped[name])
    ops.reset_launches()
    check(executor.execute(tasks, serial=False) == [],
          "phase 4b: an overlapped wide group failed")
    torch.cuda.synchronize()
    check(ops.launches()["slot_scan"] == len(tasks) == len(groups),
          f"phase 4b overlapped: launches {ops.launches()}")
    for name in serial:
        same_records(np, overlapped[name], serial[name],
                     f"phase 4b overlapped {name}")
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
        f"{variants}, {wall:.2f} s; the {len(tasks)} groups overlapped in "
        f"one executor call == serial; kernel ns per slot "
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
    sizes = list(ROWCLONE_SIZES)
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
    return (counts, detail, {emu._bucket(trs[i].n) for i in slower},
            (trs, bloom, rc.device))


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


def same_records(np, a, b, label):
    """Two record lists equal on every key of every record."""
    check(len(a) == len(b), f"{label}: record counts differ")
    for i, (ra, rb) in enumerate(zip(a, b)):
        check(set(ra) == set(rb), f"{label}: record {i} has other keys")
        for k, v in ra.items():
            w = rb[k]
            same = (np.array_equal(v, w)
                    if isinstance(v, np.ndarray) or isinstance(w, np.ndarray)
                    else v == w)
            check(bool(same), f"{label}: record {i} differs on {k}")


def search_job(arrays, seed):
    """``policysearch.search`` at its defaults on the plain engine
    (``device='cpu'``) in a worker process, over a trace given as arrays;
    returns what the card's search must equal and the seconds it took."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.core import emulator, policysearch, timescale
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    res = policysearch.search(emulator.Trace(**arrays),
                              timescale.JETSON_NANO, seed=seed, device="cpu")
    return search_summary(res), time.perf_counter() - t0


def search_summary(res):
    return {"best": res.best.digest, "best_fitness": res.best_fitness,
            "baseline_fitness": res.baseline_fitness,
            "history": res.history, "leaderboard": res.leaderboard,
            "n_evaluated": res.n_evaluated,
            "n_dispatches": res.n_dispatches}


def serial_window_loop(task):
    """One stream task's windows in order on this thread, each window's
    assembly, scan and copy-back one after another: the window loop as it
    ran before the executor."""
    state, ctx = task.pack()
    for args in task.windows(ctx):
        state, out = task.fn(state, *args)
        task.consume(tuple(o.cpu().numpy() for o in out), ctx)
    task.finalize(state, ctx)


def feeder_window_loop(task, depth=2):
    """One stream task's windows with a feeder thread that assembles up
    to ``depth`` windows ahead through a bounded queue (the reference
    executor's prefetch design), copied back one window behind as in
    ``StreamTask.run``: the two-thread design, measured beside the
    executor's one-thread loop."""
    import queue
    import threading
    from repro_torch.core.executor import _landed, _to_host_async
    state, ctx = task.pack()
    q = queue.Queue(maxsize=depth)

    def feed():
        try:
            for args in task.windows(ctx):
                q.put(args)
            q.put(None)
        except BaseException as e:   # surfaces on the consuming thread
            q.put(e)

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    behind = None
    while (args := q.get()) is not None:
        if isinstance(args, BaseException):
            raise args
        state, out = task.fn(state, *args)
        ahead, out = _to_host_async(out), None
        if behind is not None:
            task.consume(_landed(behind), ctx)
        behind = ahead
    task.consume(_landed(behind), ctx)
    th.join()
    task.finalize(state, ctx)


def grid_campaign(campaign, traces, jn, trs, bloom, rc_device, builtins):
    """Phase 5's main path as one Campaign: both tRCD arms and the
    reference mode of every PolyBench trace, the RowClone copy and init
    traces of both arms at every size, and the built-in policy grid."""
    geo = jn.geometry
    c = campaign.Campaign()
    for i, tr in enumerate(trs):
        c.add(tr, jn, i=i, arm="base")
        c.add(tr, jn, bloom=bloom, i=i, arm="reduced")
        c.add(tr, jn, mode="reference", bloom=bloom, i=i, arm="reference")
    for w, gen in (("copy", traces.copy_workload),
                   ("init", traces.init_workload)):
        for nb in ROWCLONE_SIZES:
            for arm in ("cpu", "rowclone"):
                tr, _ = gen(nb, geo, mode=arm, device=rc_device,
                            setting="noflush")
                c.add(tr, jn, workload=w, size=nb, arm=arm)
    c.add_policy_grid(trs[0], jn, builtins, arm="policy")
    return c


def phase_executor(np, torch, ops, emu, campaign, techniques, policysearch,
                   smcprog, traces, timescale, inputs, stream_detail,
                   cpu_search):
    """Phase 7d, the campaign executor at the main path's size: (i) phase
    5's grid through ``Campaign.run`` overlapped and serial in turns
    (serial, overlapped, overlapped, serial), equal on every field, with
    the same launches, the overlapped run on more than one CUDA stream,
    its device span beside the sum of its launches; (ii) checkpoint and
    resume (nothing launched), and quarantine of a poisoned group; (iii)
    phase 7c's streams through the executor's window loop against a
    feeder-thread loop, the serial window loop and single-shot, in turns,
    with their peak device memory; (iv) ``policysearch.search`` at its defaults on a phase-5
    trace, and at a cut against the plain engine's search (run in a worker
    process since the start of the script); (v)
    ``SchedulingPolicyStudy`` over the PolyBench traces with every
    built-in, ``policy_axis`` True and False equal."""
    import shutil
    import tempfile
    import threading
    jn = timescale.JETSON_NANO
    trs, bloom, rc_device = inputs
    builtins = list(smcprog.builtin_programs().values())
    grid = grid_campaign(campaign, traces, jn, trs, bloom, rc_device,
                         builtins)
    n_groups = grid.n_groups()
    check(n_groups >= 12, f"phase 7d: the grid has {n_groups} groups")

    # (i) overlapped against serial, in turns; the streams that launched,
    # and (in one more overlapped run) a pair of CUDA events around each
    # launch on its own stream: each launch's device time, and the span
    # from the first start to the last end, all from one event recorded
    # on this thread's stream before the run (the workers' streams wait
    # for it)
    orig = ops.slot_scan
    lock, seen, events = threading.Lock(), [], []

    def ss(*args):
        h = ops.stream_handle(args[0].device)
        ev = None
        if timing:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = orig(*args)
        with lock:
            seen.append(h)
            if ev is not None:
                ev[1].record()
                events.append(ev)
        return out

    timing = False

    ops.slot_scan = ss
    walls = {"serial": [], "overlapped": []}
    recs, counts, streams = {}, {}, {}
    try:
        for how in ("serial", "overlapped", "overlapped", "serial") * 2:
            torch.cuda.synchronize()
            ops.reset_launches()
            seen.clear()
            t0 = time.perf_counter()
            out = grid.run(serial=how == "serial")
            torch.cuda.synchronize()
            walls[how].append(time.perf_counter() - t0)
            recs.setdefault(how, out)
            counts.setdefault(how, ops.launches())
            streams.setdefault(how, set(seen))
            check(grid.last_run["computed"] == n_groups,
                  f"phase 7d: {how} run {grid.last_run}")
        timing = True
        torch.cuda.synchronize()
        base = torch.cuda.Event(enable_timing=True)
        base.record()
        grid.run()
        torch.cuda.synchronize()
        timing = False
    finally:
        ops.slot_scan = orig
    span = {"launches": len(events),
            "sum_ms": sum(a.elapsed_time(b) for a, b in events),
            "span_ms": max(base.elapsed_time(b) for _, b in events)
            - min(base.elapsed_time(a) for a, _ in events),
            "method": "cuda events around each launch"}
    same_records(np, recs["overlapped"], recs["serial"],
                 "phase 7d overlapped vs serial")
    check(counts["overlapped"] == counts["serial"]
          and counts["serial"]["slot_scan"] == n_groups
          and counts["serial"]["bloom_probe"] > 0,
          f"phase 7d: launches {counts}")
    check(len(streams["overlapped"]) > 1,
          f"phase 7d: every overlapped launch used one stream "
          f"({len(streams['overlapped'])})")

    # (ii) checkpoint and resume; quarantine
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        grid.run(checkpoint=tmp)
        check(grid.last_run["computed"] == n_groups
              and len(os.listdir(tmp)) == n_groups,
              f"phase 7d: checkpointing wrote {len(os.listdir(tmp))} files")
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        resumed = grid.run(checkpoint=tmp)
        resume_s = time.perf_counter() - t0
        resume_launches = ops.launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(grid.last_run["loaded"] == grid.last_run["groups"] == n_groups
          and not any(resume_launches.values()),
          f"phase 7d: the resumed run {grid.last_run} launched "
          f"{resume_launches}")
    same_records(np, resumed, recs["serial"], "phase 7d resumed")
    poison_sys = dataclasses.replace(
        jn, smc_cycles_per_decision=jn.smc_cycles_per_decision + 1)
    bad = emu.Trace.of(np.zeros(300), np.full(300, jn.geometry.n_banks),
                       np.zeros(300), np.ones(300))
    quarantined = grid_campaign(campaign, traces, jn, trs, bloom, rc_device,
                                builtins)
    quarantined.add(bad, poison_sys, arm="poison")
    quarantined.add(bad, poison_sys, mode="reference", arm="poison")
    q = quarantined.run(on_error="quarantine")
    lr = quarantined.last_run
    check(lr["failed"] == 1 and lr["computed"] == n_groups
          and all(r.get("error_type") == "ValueError" for r in q[-2:]),
          f"phase 7d: quarantine {lr}")
    same_records(np, q[:-2], recs["serial"], "phase 7d quarantined grid")

    # (iii) the stream path: the executor's window loop (next window
    # assembled while the scan runs, copy-back one window behind) against
    # a feeder thread doing the assembly, the serial window loop and
    # single-shot, in turns, with each run's peak device memory
    def streams_of(n):
        return [lambda i=i: traces.synthetic_stream(n, window=STREAM_CHUNK,
                                                    seed=i)
                for i in range(STREAM_N)]

    def executor_loop():
        return emu.run_stream_many(streams_of(STREAM_REQUESTS), jn, "ts",
                                   chunk=STREAM_CHUNK, collect="full")

    def task_loop(loop):
        out = [None] * STREAM_N
        for t in emu.prepare_stream_tasks(streams_of(STREAM_REQUESTS), jn,
                                          "ts", None, out, chunk=STREAM_CHUNK,
                                          collect="full"):
            loop(t)
        return out

    whole = [materialize(np, emu, traces.synthetic_stream(
        STREAM_REQUESTS, window=STREAM_CHUNK, seed=i))
        for i in range(STREAM_N)]
    runs = {"executor": executor_loop,
            "feeder": lambda: task_loop(feeder_window_loop),
            "serial_loop": lambda: task_loop(serial_window_loop),
            "single_shot": lambda: emu.run_many(whole, jn, "ts")}
    stream_walls = {k: [] for k in runs}
    stream_peak = {k: [] for k in runs}
    got = {}
    for name in list(runs) + list(runs)[::-1]:
        torch.cuda.synchronize()
        ops.reset_launches()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got[name] = runs[name]()
        torch.cuda.synchronize()
        stream_walls[name].append(time.perf_counter() - t0)
        stream_peak[name].append(torch.cuda.max_memory_allocated() - base)
        if name == "executor":
            n_windows = ops.launches()["slot_scan_window"]
    for name in ("feeder", "serial_loop"):
        same_records(np, got["executor"], got[name],
                     f"phase 7d executor loop vs {name}")
    for i, (a, b) in enumerate(zip(got["executor"], got["single_shot"])):
        same_stream(np, a, b, STREAM_REQUESTS, f"phase 7d stream {i}")
    check(max(stream_peak["executor"]) <= min(stream_peak["serial_loop"]),
          f"phase 7d: the executor's window loop holds more device memory "
          f"than the serial window loop: {stream_peak}")
    total = STREAM_N * STREAM_REQUESTS
    rate = {k: [total / w for w in v] for k, v in stream_walls.items()}

    # (iv) the policy search: defaults on a phase-5 trace, then the cut
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = policysearch.search(trs[0], jn, seed=SEARCH_SEED)
    full_s = time.perf_counter() - t0
    cut = emu.Trace(*(getattr(trs[0], f)[:SEARCH_CUT]
                      for f in ("kind", "bank", "row", "delta", "dep")))
    t0 = time.perf_counter()
    card_cut = search_summary(policysearch.search(cut, jn, seed=SEARCH_SEED))
    card_cut_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_cut, plain_cut_s = cpu_search.get()
    wait_s = time.perf_counter() - t0
    check(card_cut == plain_cut,
          f"phase 7d: the search at the cut differs from the plain "
          f"engine's: {card_cut} vs {plain_cut}")

    # (v) the scheduling study over every PolyBench trace and built-in
    study = techniques.SchedulingPolicyStudy(jn)
    t0 = time.perf_counter()
    axis = study.evaluate_traces(trs)
    axis_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = study.evaluate_traces(trs, policy_axis=False)
    staged_s = time.perf_counter() - t0
    check(axis == staged, "phase 7d: the study differs between policy_axis "
                          "True and False")

    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    span_txt = (f"{span['span_ms']:.2f} ms of device span for "
                f"{span['launches']} launches summing {span['sum_ms']:.2f} "
                f"ms (CUDA events)")
    host = stream_detail["host_ms_per_window"]
    peak = stream_detail["peak_device_bytes"]
    say(f"phase 7d executor: phase 5's grid ({len(grid)} points, "
        f"{n_groups} groups) through Campaign.run: overlapped == serial on "
        f"every field, launches {counts['serial']} both; wall serial "
        f"{[round(w, 4) for w in walls['serial']]} s, overlapped "
        f"{[round(w, 4) for w in walls['overlapped']]} s; "
        f"{len(streams['overlapped'])} CUDA streams launched slot_scan "
        f"overlapped ({len(streams['serial'])} serial); overlapped "
        f"{span_txt}")
    say(f"phase 7d checkpoint: resumed run loaded {n_groups} of {n_groups} "
        f"groups in {resume_s:.3f} s, launched nothing, records equal; "
        f"quarantine: the poisoned group failed alone, the other "
        f"{n_groups} groups equal the serial run")
    say(f"phase 7d stream: {STREAM_N} x {STREAM_REQUESTS} requests, the "
        f"executor's window loop == feeder thread == serial window loop == "
        f"single-shot on every field; {n_windows} windows; requests/s in "
        f"turns: " + ", ".join(
            f"{k} {[round(r) for r in v]}" for k, v in rate.items())
        + "; peak device bytes: " + ", ".join(
            f"{k} {v}" for k, v in stream_peak.items())
        + "; host ms per window by part (phase 7c) " + ", ".join(
            f"{k} {v:.3f}" for k, v in host.items())
        + f"; phase 7c peak device memory {peak} bytes")
    say(f"phase 7d policy search: defaults on {traces.POLYBENCH[0].name} "
        f"({trs[0].n_real} requests): {full.n_evaluated} programs in "
        f"{full.n_dispatches} generations, {full_s:.2f} s, best "
        f"{full.best.digest} x{full.improvement:.4f} vs "
        f"{full.baseline.name}; at a {SEARCH_CUT}-request cut the card's "
        f"search ({card_cut_s:.2f} s) == the plain engine's "
        f"({plain_cut_s:.1f} CPU-s, waited {wait_s:.1f} s): best digest, "
        f"fitness, history and leaderboard")
    say(f"phase 7d SchedulingPolicyStudy: {len(trs)} traces x "
        f"{len(builtins)} built-ins, policy_axis True {axis_s:.2f} s == "
        f"False {staged_s:.2f} s")
    return grid, recs["serial"], {
        "groups": n_groups, "points": len(grid), "wall_s": walls,
        "median_wall_s": med, "launches": counts["serial"],
        "streams": {k: len(v) for k, v in streams.items()},
        "overlapped_device": span, "resume_s": resume_s,
        "quarantine": {k: lr[k] for k in ("groups", "computed", "failed")},
        "stream": {"windows": n_windows, "wall_s": stream_walls,
                   "requests_per_s": rate, "peak_device_bytes": stream_peak},
        "search": {"full_s": full_s, "full": search_summary(full),
                   "cut_card_s": card_cut_s, "cut_plain_cpu_s": plain_cut_s,
                   "cut_wait_s": wait_s, "cut": card_cut},
        "study_s": {"policy_axis": axis_s, "staged": staged_s}}


def service_pass(service, grid, server, threads):
    """Phase 7d's grid through ``server`` from three clients (weights
    ``SERVICE_WEIGHTS``), point j to client j % 3, submitted one point at a
    time in grid order: from one thread each (``threads``) or interleaved
    from this one. Returns the records in grid order and the wall seconds
    from the first submission to the last record."""
    import threading
    clis = [service.SweepClient(server=server, name=f"c{k}", weight=w)
            for k, w in enumerate(SERVICE_WEIGHTS)]
    mine = [list(range(k, len(grid.points), len(clis)))
            for k in range(len(clis))]
    out = [None] * len(grid.points)
    errs = []

    def client(k):
        try:
            for i in mine[k]:
                clis[k].submit_points([grid.points[i]])
            for i, r in zip(mine[k], clis[k].collect(timeout=600)):
                out[i] = r
        except Exception as e:   # re-raised on the calling thread
            errs.append(e)

    t0 = time.perf_counter()
    if threads:
        ths = [threading.Thread(target=client, args=(k,))
               for k in range(len(clis))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(600)
    else:
        for i, p in enumerate(grid.points):
            clis[i % len(clis)].submit_points([p])
        for k, cli in enumerate(clis):
            for i, r in zip(mine[k], cli.collect(timeout=600)):
                out[i] = r
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return out, wall


def standalone_server(np, service, grid, serial, pick):
    """``python -m repro_torch.service`` in a process of its own, started
    with ``--persistent-cache``: its stats before the first submission
    (the library loaded, nothing dispatched), the points ``pick`` over a
    socket (equal to ``serial``), its stats after, and a typed
    ``QueueFullError`` past ``--max-pending``. The process is stopped with
    Ctrl-C (a drain) and killed if it does not exit."""
    import select
    import signal
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    err = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "--port", "0",
         "--max-pending", str(SERVICE_MAX_PENDING), "--persistent-cache"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 300)
        line = proc.stdout.readline() if ready else ""
        if "listening on" not in line:
            err.seek(0)
            check(False, f"phase 7e: the standalone server did not start: "
                         f"{line!r} {err.read()[-2000:]}")
        start_s = time.perf_counter() - t0
        host, port = line.split("listening on ")[1].split()[0].rsplit(":", 1)
        with service.SweepClient(address=(host, int(port)),
                                 name="far") as cli:
            before = cli.stats()
            walls = []
            for _ in range(2):   # the process's first dispatches, then warm
                t0 = time.perf_counter()
                cli.submit_points([grid.points[i] for i in pick])
                got = cli.collect(timeout=600)
                walls.append(time.perf_counter() - t0)
            after = cli.stats()
            try:
                cli.submit_points([grid.points[pick[0]]]
                                  * (SERVICE_MAX_PENDING + 1))
                refused = None
            except service.QueueFullError as e:
                refused = e
        proc.send_signal(signal.SIGINT)
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
    same_records(np, got, [serial[i] for i in pick],
                 "phase 7e standalone server")
    pers = before["compile"]["persistent"]
    check(before["dispatches"]["count"] == 0
          and pers["hits"] + pers["misses"] == 1 and pers["dir"]
          and before["device"].startswith("cuda"),
          f"phase 7e: the standalone server before its first dispatch: "
          f"{before['dispatches']} {pers} {before['device']}")
    check(after["clients"]["far"]["completed"] == 2 * len(pick),
          f"phase 7e: stats over the socket {after['clients']}")
    check(refused is not None and refused.scope == "per-client"
          and refused.bound == SERVICE_MAX_PENDING
          and refused.requested == SERVICE_MAX_PENDING + 1,
          f"phase 7e: no typed QueueFullError over the socket ({refused})")
    check(code == 0, f"phase 7e: the standalone server exited {code}")
    frames = {"submit_bytes": len(pickle.dumps(
                  [grid.points[i] for i in pick],
                  protocol=pickle.HIGHEST_PROTOCOL)),
              "records_bytes": len(pickle.dumps(
                  got, protocol=pickle.HIGHEST_PROTOCOL))}
    return {"start_s": start_s, "wall_s": walls, "points": len(pick),
            "frames": frames,
            "persistent": pers, "dispatches": after["dispatches"],
            "latency_ms": after["latency_ms"],
            "refused": {"scope": refused.scope, "bound": refused.bound,
                        "requested": refused.requested}}


def phase_service(np, torch, ops, emu, service, grid, serial):
    """Phase 7e, the sweep service over phase 7d's grid: (i) three
    in-process clients (weights 1, 1, 2) submit the grid interleaved, with
    a window long enough for every point to land first: every record
    equals the serial ``Campaign.run``, every group is one dispatch shared
    by more than one client, and the plan cache (cleared before) misses
    once a group; then timed runs in turns with ``Campaign.run`` overlapped
    (campaign, service, service, campaign), the service at its default
    window with a thread a client: wall time, dispatches, points per
    dispatch, coalescing ratio, latency percentiles; (ii) the same grid
    again on the first server: the plan cache misses nothing; (iii)
    ``python -m repro_torch.service`` in a process of its own: the
    RowClone and policy points over a socket, stats over the socket, a
    typed ``QueueFullError``; (iv) a drain-close with a checkpoint
    directory: a new server on it answers with nothing launched, every
    dispatch loaded, and so does ``Campaign.run(checkpoint=...)``; (v)
    ``persistent_cache=True``: the standalone server's library was loaded
    before its first dispatch, and an in-process server reports the
    build."""
    import shutil
    import tempfile
    n_groups = grid.n_groups()

    # (i) coalescing and exactness, with the plan cache cleared before
    emu.cache_clear()
    torch.cuda.synchronize()
    ops.reset_launches()
    srv = service.SweepServer(coalesce_window_s=SERVICE_LONG_WINDOW_S)
    try:
        first, first_s = service_pass(service, grid, srv, threads=False)
        torch.cuda.synchronize()
        counts = ops.launches()
        st1 = srv.stats()
        # (ii) the same grid again on the warm server
        second, second_s = service_pass(service, grid, srv, threads=False)
        st2 = srv.stats()
    finally:
        srv.close()
    same_records(np, first, serial, "phase 7e three clients")
    same_records(np, second, serial, "phase 7e second pass")
    for name in PATH_KERNELS:
        check(counts[name] > 0, f"phase 7e: the service launched no {name} "
                                f"({counts})")
    check(counts["slot_scan"] == n_groups
          and st1["dispatches"]["count"] == n_groups
          and st1["coalesce_ratio"] > 1.0,
          f"phase 7e: {st1['dispatches']} coalesce ratio "
          f"{st1['coalesce_ratio']}, launches {counts}")
    check(st1["compile"]["misses"] == n_groups
          and st1["compile"]["hits"] == 0,
          f"phase 7e: first pass plan cache {st1['compile']}")
    second_cache = {k: st2["compile"][k] - st1["compile"][k]
                    for k in ("hits", "misses")}
    check(second_cache == {"hits": n_groups, "misses": 0},
          f"phase 7e: second pass plan cache {second_cache}")

    # timed: Campaign.run overlapped and the service, in turns
    walls = {"campaign": [], "service": []}
    runs = []
    for how in ("campaign", "service", "service", "campaign") \
            * SERVICE_TURNS:
        torch.cuda.synchronize()
        if how == "campaign":
            t0 = time.perf_counter()
            out = grid.run()
            torch.cuda.synchronize()
            walls[how].append(time.perf_counter() - t0)
        else:
            with service.SweepServer() as srv:
                out, wall = service_pass(service, grid, srv, threads=True)
                torch.cuda.synchronize()
                st = srv.stats()
            walls[how].append(wall)
            runs.append({k: st[k] for k in (
                "dispatches", "points_per_dispatch", "coalesce_ratio",
                "latency_ms")})
        same_records(np, out, serial, f"phase 7e timed {how}")

    # (iii) and (v): the standalone server on a socket
    pick = [i for i, p in enumerate(grid.points)
            if "workload" in p.meta or p.meta.get("arm") == "policy"]
    standalone = standalone_server(np, service, grid, serial, pick)

    # (iv) checkpoint: drain-close, then a new server and a Campaign on it
    tmp = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        srv = service.SweepServer(checkpoint=tmp,
                                  coalesce_window_s=SERVICE_LONG_WINDOW_S)
        cli = service.SweepClient(server=srv, name="a")
        cli.submit_points(grid.points)
        srv.close(drain=True)
        drained = cli.collect(timeout=600)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with service.SweepServer(checkpoint=tmp) as srv:
            cli = service.SweepClient(server=srv, name="b")
            cli.submit_points(grid.points)
            loaded = cli.collect(timeout=600)
            st_ck = srv.stats()
        load_s = time.perf_counter() - t0
        resumed = grid.run(checkpoint=tmp)
        ck_launches = ops.launches()
        files = len([f for f in os.listdir(tmp) if f.startswith("group-")])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, recs in (("drained", drained), ("loaded", loaded),
                       ("resumed", resumed)):
        same_records(np, recs, serial, f"phase 7e checkpoint {name}")
    check(files == n_groups and not any(ck_launches.values())
          and st_ck["dispatches"]["loaded_from_checkpoint"]
          == st_ck["dispatches"]["count"] == n_groups
          and grid.last_run["loaded"] == n_groups,
          f"phase 7e: checkpoint files {files}, launches {ck_launches}, "
          f"{st_ck['dispatches']}, campaign {grid.last_run}")

    # (v) in-process: persistent_cache=True reports the library's build
    with service.SweepServer(persistent_cache=True) as srv:
        pers = srv.stats()["compile"]["persistent"]
    check(pers["hits"] + pers["misses"] == 1 and pers["dir"],
          f"phase 7e: persistent_cache in-process {pers}")

    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    last = runs[-1]
    say(f"phase 7e service: phase 5's grid ({len(grid.points)} points, "
        f"{n_groups} groups) from 3 in-process clients (weights "
        f"{list(SERVICE_WEIGHTS)}) == serial Campaign.run on every field; "
        f"{SERVICE_LONG_WINDOW_S * 1e3:.0f} ms window: {n_groups} "
        f"dispatches, coalesce ratio {st1['coalesce_ratio']:.2f}, launches "
        f"{counts}, {first_s:.4f} s; plan cache first pass "
        f"{st1['compile']['misses']} misses, second pass {second_cache}")
    say(f"phase 7e timed in turns (4 ms window, a thread a client): "
        f"service {[round(w, 4) for w in walls['service']]} s, "
        f"Campaign.run overlapped {[round(w, 4) for w in walls['campaign']]}"
        f" s; last service run {last['dispatches']['count']} dispatches, "
        f"{last['points_per_dispatch']:.2f} points a dispatch, coalesce "
        f"ratio {last['coalesce_ratio']:.2f}, latency ms p50 "
        f"{last['latency_ms']['p50']} p90 {last['latency_ms']['p90']} p99 "
        f"{last['latency_ms']['p99']}")
    say(f"phase 7e standalone server: started in "
        f"{standalone['start_s']:.1f} s (library loaded before its first "
        f"dispatch: {standalone['persistent']}), {len(pick)} RowClone and "
        f"policy points over a socket == serial in "
        f"{[round(w, 4) for w in standalone['wall_s']]} s (the process's "
        f"first dispatches, then warm; frames {standalone['frames']} "
        f"bytes), typed QueueFullError "
        f"{standalone['refused']}; checkpoint: a new server loaded "
        f"{n_groups} of {n_groups} dispatches in {load_s:.3f} s, launched "
        f"nothing, and Campaign.run resumed from the service's files")
    return {"groups": n_groups, "points": len(grid.points),
            "coalescing": {"dispatches": st1["dispatches"],
                           "coalesce_ratio": st1["coalesce_ratio"],
                           "wall_s": first_s, "launches": counts},
            "plan_cache": {"first": st1["compile"], "second": second_cache},
            "wall_s": walls, "median_wall_s": med, "timed_runs": runs,
            "standalone": standalone, "checkpoint_load_s": load_s,
            "persistent_in_process": pers}


def ref_cases(np, emu, smcprog, timescale, traces, faults, bloom_mod):
    """``REF_CASES``: name -> (traces, system, ``run_ref_many`` keyword
    arguments), seeded cut groups of 24-300 requests: ts, nots and
    reference with a shared Bloom filter, a Bloom filter per trace, the
    built-in policies as runtime tables, a staged policy, PARA without a
    fault model, phase 7b's fault model under the legacy scheduler and
    under the mitigation programs, and a window of 80 over 128 banks with a
    512-row table."""
    jn = timescale.JETSON_NANO
    rng = np.random.RandomState(REF_SEED)

    def trace(n, n_banks=16):
        return emu.Trace.of(
            kind=rng.choice(5, n, p=(0.5, 0.3, 0.05, 0.05, 0.1)),
            bank=rng.randint(0, n_banks, n), row=rng.randint(0, 256, n),
            delta=rng.randint(0, 40, n), dep=rng.randint(0, 5, n))

    def bloom():
        keys = rng.randint(0, 16 * 256, 1500).astype(np.uint32)
        bf = bloom_mod.BloomFilter.build(keys, m_bits=1 << 13, k=3)
        return (bf.bits, bf.k, bf.m_bits)

    fm = faults.FaultModel(**STUDY_FM)
    builtins = list(smcprog.builtin_programs().values())
    mit = list(smcprog.mitigation_programs(para_fp=20000,
                                           trr_threshold=4).values())
    storms = [traces.rowhammer_trace(n, jn.geometry, intensity=x, seed=i)
              for i, (n, x) in enumerate(((300, 0.9), (200, 0.7)))]
    wide = dataclasses.replace(jn, window=80, geometry=dataclasses.replace(
        jn.geometry, n_banks=128))
    long = long_program(smcprog, 300)
    trs = [trace(n) for n in (300, 240, 24, 150)]

    def costs(progs):
        return {"policies": progs,
                "policy_costs": [p.smc_cycles() for p in progs]}
    return {
        "modes-bloom-shared": (trs, jn, {
            "mode": ["ts", "nots", "reference", "ts"], "blooms": bloom()}),
        "bloom-per-trace": (trs[:3], jn, {"blooms": [bloom()
                                                     for _ in range(3)]}),
        "runtime-policies": ([trs[1]] * len(builtins), jn,
                             costs(builtins)),
        "staged-policy": (trs[:2], jn.with_policy(builtins[2]),
                          {"mode": "nots"}),
        "para-no-fault-model": ([storms[0]] * len(mit), jn, costs(mit)),
        "faults-legacy": (storms, jn.with_faults(fm), {}),
        "faults-policies": ([storms[1]] * len(mit), jn.with_faults(fm),
                            costs(mit)),
        "wide-q80-banks128-table512": (
            [trace(30, 128), trace(24, 128)], wide,
            {"policies": [long, builtins[0]],
             "policy_costs": [long.smc_cycles(), 40]}),
    }


def plain_ref_job(arrays, bloom, params):
    """One recorded ``ref_scan`` group through its plain version on the
    CPU, in a worker process; returns its output fields and seconds."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.slot_scan import ScanParams
    torch.set_num_threads(1)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in arrays.items()}
    bf = None if bloom is None else (torch.from_numpy(bloom[0]),) + bloom[1:]
    t0 = time.perf_counter()
    out = ref.ref_scan_ref(t["kind"], t["bank"], t["row"], t["delta"],
                           t["dep"], bf, t["tables"], t["costs"],
                           ScanParams(**params))
    return {f: v.numpy() for f, v in out.items()}, time.perf_counter() - t0


def ref_group_ns(cuda, groups):
    """ms per call and ns per budget slot of each recorded group, each
    relaunched once on its own inputs."""
    out = []
    for g in groups:
        p = g["args"][-1]
        ms = cuda(g["args"])
        out.append({"tag": g["tag"], "batch": p.batch, "n": p.n,
                    "slots": p.slots, "table_len": p.table_len, "ms": ms,
                    "ns_per_slot": ms * 1e6 / max(p.slots, 1)})
    return out


def phase_ref(np, torch, ops, ref, emu, smcprog, timescale, traces, faults,
              bloom_mod, inputs, grid, grid_serial):
    """Phase 7f, the reference engine and sharding: (a) ``ref_scan`` on the
    ``REF_CASES`` cuts against its plain version in CPU workers, every
    field; (b) ``run_ref_many`` over phase 5's inputs at full size (counters
    reset just before), equal to ``run_many`` on every field, with its
    launches, time and ns per slot beside ``slot_scan``'s on the same
    groups; (c) phase 7d's grid under ``set_sharding('force')`` (and
    'auto' across cards on a host with more than one), equal to the
    unsharded records, the plan cache missing once a group on the first
    pass and never on the second. Returns the kernel's JSON entry."""
    t_phase = time.perf_counter()
    jn = timescale.JETSON_NANO
    geo = jn.geometry

    # (a) the cuts: kernel against plain, on the recorded inputs
    cases = ref_cases(np, emu, smcprog, timescale, traces, faults, bloom_mod)
    rec = Recorder(ops, ref, emu.NOP, emu.BIG)
    rec.record()
    for name, (trs, sys_, kw) in cases.items():
        rec.tag = name
        emu.run_ref_many(trs, sys_, **kw)
    rec.restore()
    torch.cuda.synchronize()
    flips = sum(int(g["out"]["flips"].sum()) for g in rec.refs
                if "flips" in g["out"])
    check(flips > 0, "phase 7f: the fault cuts flipped nothing")
    names = ("kind", "bank", "row", "delta", "dep")
    jobs = []
    for g in rec.refs:
        a = g["args"]
        arrays = {n: t.cpu().numpy() for n, t in zip(names, a[:5])}
        arrays["tables"] = None if a[6] is None else a[6].cpu().numpy()
        arrays["costs"] = a[7].cpu().numpy()
        bloom = None if a[5] is None else (a[5][0].cpu().numpy(),) \
            + tuple(a[5][1:])
        jobs.append((g, arrays, bloom))
    # longest first: the plain cost grows with the table's rows a lane and
    # with the fault draws
    jobs.sort(key=lambda j: -j[0]["args"][-1].slots
              * (1 + j[0]["args"][-1].table_len * j[0]["args"][-1].q // 16)
              * (4 if j[0]["args"][-1].faults else 1))
    workers = min(len(jobs), len(os.sched_getaffinity(0)), MAX_WORKERS)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(plain_ref_job, arrays, bloom,
                            dataclasses.asdict(g["args"][-1]))
                for g, arrays, bloom in jobs]
        results = [f.result() for f in futs]
    cut_wall = time.perf_counter() - t0
    err = 0
    for (g, _, _), (want, _) in zip(jobs, results):
        got = g["out"]
        check(set(got) == set(want), f"phase 7f: ref_scan and its plain "
                                     f"version give other fields ({g['tag']})")
        for f in want:
            e = int(np.abs(got[f].astype(np.int64)
                           - want[f].astype(np.int64)).max())
            err = max(err, e)
            check(e == 0, f"phase 7f: ref_scan != plain on {f} in the "
                          f"{g['tag']} cut")
    cut_cpu_s = sum(s for _, s in results)

    # (b) full size: run_many's records, then run_ref_many's on the same
    # calls with the counters reset just before
    trs, bloom, rc_device = inputs
    rc_trs = [gen(nb, geo, mode=arm, device=rc_device, setting="noflush")[0]
              for gen in (traces.copy_workload, traces.init_workload)
              for nb in ROWCLONE_SIZES for arm in ("cpu", "rowclone")]
    builtins = list(smcprog.builtin_programs().values())
    calls = {
        "trcd-base": ((trs, jn), {}),
        "trcd-reduced-reference": ((trs + trs, jn), {
            "mode": ["ts"] * len(trs) + ["reference"] * len(trs),
            "blooms": bloom}),
        "rowclone": ((rc_trs, jn), {}),
        "policies": (([trs[0]] * len(builtins), jn), {
            "policies": builtins,
            "policy_costs": [p.smc_cycles() for p in builtins]}),
    }
    fast_rec = Recorder(ops, ref, emu.NOP, emu.BIG)
    fast_rec.record()
    fast = {}
    for tag, (a, kw) in calls.items():
        fast_rec.tag = tag
        fast[tag] = emu.run_many(*a, **kw)
    fast_rec.restore()
    full = Recorder(ops, ref, emu.NOP, emu.BIG)
    torch.cuda.synchronize()
    ops.reset_launches()
    full.record()
    t0 = time.perf_counter()
    slow = {}
    for tag, (a, kw) in calls.items():
        full.tag = tag
        slow[tag] = emu.run_ref_many(*a, **kw)
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    counts = ops.launches()
    full.restore()
    check(counts["ref_scan"] > 0 and counts["slot_scan"] == 0
          and counts["bloom_probe"] == 0,
          f"phase 7f: run_ref_many launched {counts}")
    for tag in calls:
        same_records(np, slow[tag], fast[tag], f"phase 7f run_ref == run "
                                               f"({tag})")
    kern = full.orig["ref_scan"]
    scan = full.orig["slot_scan"]
    refs = ref_group_ns(lambda a: cuda_ms(lambda: kern(*a), reps=1),
                        full.refs)
    fasts = ref_group_ns(lambda a: cuda_ms(lambda: scan(*a), reps=1),
                         fast_rec.groups)
    pairs = []
    for r in refs:   # the same group of the same call in both engines
        f = next((f for f in fasts if (f["tag"], f["batch"], f["n"],
                                       f["table_len"])
                  == (r["tag"], r["batch"], r["n"], r["table_len"])), None)
        if f is not None:
            pairs.append({"ref": r, "slot_scan": f,
                          "ratio_per_slot": r["ns_per_slot"]
                          / f["ns_per_slot"]})
    big = max(full.refs, key=lambda g: (g["args"][-1].slots,
                                       g["args"][-1].batch))
    args = big["args"]
    p = args[-1]
    ms = cuda_ms(lambda: kern(*args), reps=2)
    dev_fields = device_fields(lambda: kern(*args), "ref_scan_kernel")
    cut = dataclasses.replace(p, slots=min(p.slots, 200))
    cargs = args[:-1] + (cut,)
    kc, pc = kern(*cargs), ref.ref_scan_ref(*cargs)
    err = max(err, max(float((kc[f] - pc[f]).abs().max()) for f in FIELDS))
    check(err == 0, f"phase 7f: ref_scan != plain over a {cut.slots}-slot "
                    f"cut of the largest group")
    plain_ms = cuda_ms(lambda: ref.ref_scan_ref(*cargs), reps=1)
    B, N = p.batch, p.n
    words = args[5][0] if args[5] is not None else None
    nbytes = B * N * (5 * 4 + 2 * 4) + B * 5 * 4 \
        + (words.numel() * 4 if words is not None else 0) \
        + (args[6].numel() * 4 if args[6] is not None else 0)
    nops = B * p.slots * (200 + 15 * p.table_len * p.q)
    bms, bby = bound_ms(nbytes, nops)

    # (c) sharding: phase 7d's grid forced through the shard path, then
    # 'auto' across the cards where there is more than one
    n_groups = grid.n_groups()
    shard = {"cards": torch.cuda.device_count()}
    modes = ["force"] + (["auto"] if shard["cards"] > 1 else [])
    old = emu.set_sharding("force")
    try:
        for mode in modes:
            emu.set_sharding(mode)
            passes = []
            for _ in range(2):
                c0 = emu.cache_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = grid.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c1 = emu.cache_stats()
                same_records(np, out, grid_serial, f"phase 7f {mode} grid")
                passes.append({"wall_s": wall,
                               "misses": c1["misses"] - c0["misses"],
                               "hits": c1["hits"] - c0["hits"]})
            check(passes[0]["misses"] == n_groups
                  and passes[1]["misses"] == 0
                  and passes[1]["hits"] == n_groups,
                  f"phase 7f {mode}: plan cache {passes} over {n_groups} "
                  f"groups")
            shard[mode] = passes
    finally:
        emu.set_sharding(old)

    entry = {"name": "ref_scan", "route": "cuda",
             "source": SOURCES["ref_scan"], "replaces": REPLACES["ref_scan"],
             "launches": counts["ref_scan"], "max_abs_err": float(err),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": bby, "library_ms": None, **dev_fields,
             "slots": p.slots, "plain_slots": cut.slots,
             "ns_per_slot": ms * 1e6 / p.slots,
             "shape": f"{big['tag']} group, batch {B} x {N} requests, "
                      f"{p.slots} slots"}
    detail = {"cuts": {"groups": len(jobs), "plain_cpu_s": cut_cpu_s,
                       "wall_s": cut_wall, "flips": flips},
              "full": {"wall_s": full_wall, "launches": counts["ref_scan"],
                       "groups": refs, "pairs": pairs},
              "sharding": shard, "seconds": time.perf_counter() - t_phase}
    say(f"phase 7f reference engine: ref_scan == plain on every field over "
        f"{len(jobs)} cut groups ({', '.join(cases)}; plain "
        f"{cut_cpu_s:.1f} CPU-s, {cut_wall:.1f} s; {flips} flips); "
        f"run_ref_many == run_many on every field at full size "
        f"({', '.join(calls)}), {counts['ref_scan']} ref_scan launches in "
        f"{full_wall:.2f} s")
    for pr in pairs:
        r, f = pr["ref"], pr["slot_scan"]
        say(f"  {r['tag']} group {r['batch']} x {r['n']}: ref_scan "
            f"{r['ns_per_slot']:.1f} ns per slot over {r['slots']} slots "
            f"({r['ms']:.2f} ms), slot_scan {f['ns_per_slot']:.1f} over "
            f"{f['slots']} ({f['ms']:.2f} ms)")
    say(f"phase 7f ref_scan: {ms:.3f} ms per call on the {big['tag']} "
        f"group ({B} x {N}, {p.slots} slots), device "
        f"{dev_fields['device_ms']:.3f} ms per launch "
        f"({dev_fields['device_ms_method']}), plain {plain_ms:.1f} ms over "
        f"{cut.slots} slots, bound {bms:.5f} ms by {bby}")
    say(f"phase 7f sharding on {shard['cards']} card(s): "
        + "; ".join(f"'{m}' grid ({n_groups} groups) == unsharded, passes "
                    f"{shard[m]}" for m in modes)
        + ("" if shard["cards"] > 1 else
           "; one card here, so 'auto' (across cards) did not run")
        + f"; phase 7f {detail['seconds']:.1f} s")
    return entry, detail


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
    and a copy of the prefill cache (the decode steps update a mamba
    layer's states in place), and ``ops.flash_attention_bhsd`` and
    ``ops.selective_scan`` to keep each one's first call's inputs;
    ``plain_flash`` sends their calls to the plain versions instead of
    the kernels."""

    def __init__(self, model, ops, ref):
        self.model, self.ops, self.ref = model, ops, ref
        self.orig = (model.prefill_fn, model.decode_fn,
                     ops.flash_attention_bhsd)
        self.orig_scan = ops.selective_scan
        self.flash_args = self.scan_args = None
        self.run = None

    def start(self, plain_flash=False):
        prefill, decode, flash = self.orig
        scan = self.orig_scan
        run = self.run = {"prefill": None, "steps": [], "prefill_s": 0.0}

        def rec_flash(q, k, v, causal=True):
            if self.flash_args is None:
                self.flash_args = (q, k, v, causal)
            return (self.ref.flash_attention_ref if plain_flash else flash)(
                q, k, v, causal)

        def rec_scan(*args):
            if self.scan_args is None:
                self.scan_args = args
            return (self.ref.selective_scan_ref if plain_flash else scan)(
                *args)

        def rec_prefill(params, batch):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch)
            torch.cuda.synchronize()
            run["prefill_s"] += time.perf_counter() - t0
            run["prefill"] = (logits, {pos: {k: t.clone() for k, t in
                                             leaves.items()}
                                       for pos, leaves in cache.items()})
            return logits, cache

        def rec_decode(params, cache, token, pos):
            logits, cache = decode(params, cache, token, pos)
            run["steps"].append(logits)
            return logits, cache

        self.model.prefill_fn = rec_prefill
        self.model.decode_fn = rec_decode
        self.ops.flash_attention_bhsd = rec_flash
        self.ops.selective_scan = rec_scan

    def stop(self):
        (self.model.prefill_fn, self.model.decode_fn,
         self.ops.flash_attention_bhsd) = self.orig
        self.ops.selective_scan = self.orig_scan
        return self.run


def margins(torch, logits, vocab):
    """Top-1 minus top-2 logit per row, ``[B]``."""
    top = torch.topk(logits[:, -1, :vocab].float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


class RouteRecorder:
    """Wraps ``moe.route`` to keep each call's routing in call order (a
    prefill's layers, then each decode step's): the chosen experts sorted
    per token (their order within the top k does not change a slot or a
    sum), whether each was kept, in the same order, and the K+1 largest
    probabilities."""

    def __init__(self, moe_mod):
        self.mod, self.orig = moe_mod, moe_mod.route
        self.calls = None

    def start(self):
        import torch
        calls = self.calls = []
        orig = self.orig

        def rec(p, cfg, x):
            r = orig(p, cfg, x)
            idx, order = torch.sort(r.expert_idx, dim=-1)
            calls.append({"idx": idx, "keep": torch.gather(r.keep, -1, order),
                          "top": torch.topk(r.probs, cfg.moe.top_k + 1,
                                            dim=-1).values})
            return r
        self.mod.route = rec

    def stop(self):
        self.mod.route = self.orig
        return self.calls


def same_routing(torch, a, b):
    return len(a) == len(b) and all(
        torch.equal(x[k], y[k]) for x, y in zip(a, b)
        for k in ("idx", "keep", "top"))


def compare_routes(torch, kern, plain, tokens, tokens_plain, marg, scale,
                   per_forward):
    """The kernel route's routing and greedy tokens against the plain
    route's. Call by call, a row is compared until its routing first
    differs or its tokens split: in that call every token routed to
    another set of experts must sit at a near-tie (see MOE_TIE_RTOL), and
    a kept flag may differ only at or after such a token of its group
    (its slot moved). Greedy tokens are compared as phase 9 compares them
    while a row's routing agrees. Returns the counts, the flips (with the
    bound each was held to), each row's first differing call (None:
    none) and the largest drift between the routes' probabilities at
    tokens routed alike, prefill and decode apart. ``per_forward`` is the
    routing calls a forward makes (0 for a dense model: then only the
    tokens are compared)."""
    check(len(kern) == len(plain) == per_forward * LM_NEW,
          f"routing calls: {len(kern)} / {len(plain)} for {per_forward} "
          f"a forward x {LM_NEW} forwards")
    rows = tokens.shape[0]
    first = [None] * rows          # first call whose routing differs
    stopped = [False] * rows       # tokens split or routing differs
    flips, decisions, compared, split = [], 0, 0, 0
    min_gap = math.inf
    # how far the routes' K+1 largest probabilities drift apart (relative
    # to the K-th) at tokens routed alike, prefill and decode apart
    drift = {"prefill": 0.0, "decode": 0.0}

    def call(c):
        nonlocal decisions, min_gap
        A, P = kern[c], plain[c]
        G, M, K = P["idx"].shape
        per_row = G // rows
        top = P["top"].float()
        gap = ((top[..., K - 1] - top[..., K]) / top[..., K - 1]).cpu()
        rel = ((A["top"].float() - top).abs().amax(-1)
               / top[..., K - 1]).cpu()
        moved = (A["idx"] != P["idx"]).any(-1).cpu()
        kept = (A["keep"] != P["keep"]).any(-1).cpu()
        after = torch.cummax(moved.int(), dim=1).values.bool()
        prefill = c < per_forward
        for r in range(rows):
            if stopped[r]:
                continue
            sl = slice(r * per_row, (r + 1) * per_row)
            decisions += per_row * M * K
            min_gap = min(min_gap, float(gap[sl].min()))
            alike = ~moved[sl]
            d = float(rel[sl][alike].max()) if alike.any() else 0.0
            kind = "prefill" if prefill else "decode"
            drift[kind] = max(drift[kind], d)
            check(not prefill or d <= LOGIT_TOL,
                  f"call {c} row {r}: the routes' probabilities differ by "
                  f"{d:.3g} of the K-th at tokens routed alike")
            if not (moved[sl].any() or kept[sl].any()):
                continue
            bound = max(MOE_TIE_RTOL, 2 * d) if prefill else CACHE_RTOL
            for g, m in moved[sl].nonzero().tolist():
                g += r * per_row
                flips.append({"call": c, "row": r, "group": g, "token": m,
                              "gap": float(gap[g, m]), "bound": bound})
                check(float(gap[g, m]) < bound,
                      f"call {c} row {r} group {g} token {m}: routed "
                      f"differently at a probability gap "
                      f"{float(gap[g, m]):.3g} (not a near-tie: bound "
                      f"{bound:.3g})")
            check(bool((kept[sl].int() <= after[sl].int()).all()),
                  f"call {c} row {r}: a kept flag differs with no moved "
                  f"choice before it in its group")
            first[r], stopped[r] = c, True

    for c in range(per_forward):
        call(c)
    for t in range(LM_NEW):
        for r in range(rows):
            if stopped[r]:
                continue
            if tokens[r, t] == tokens_plain[r, t]:
                compared += 1
                continue
            check(marg[r, t] <= LOGIT_TOL * scale,
                  f"row {r} step {t}: greedy tokens differ at a top-2 "
                  f"margin {marg[r, t]} above the tolerance")
            split += 1
            stopped[r] = True
        if t < LM_NEW - 1:
            for c in range(per_forward * (t + 1), per_forward * (t + 2)):
                call(c)
    return {"decisions": decisions, "flips": flips, "first": first,
            "tokens_compared": compared, "rows_split_at_small_margin": split,
            "min_gap": min_gap, "drift": drift}


def phase_serve(torch, np, ops, ref, dev, lm, moe_mod, cfg, label):
    """``cfg`` at full width served through ``ServeEngine.generate_batch``
    (LM_BATCH prompts of LM_PROMPT tokens, LM_NEW new), the launch
    counters reset just before (one flash launch an attention layer, one
    selective_scan launch a mamba layer), then again with the kernels
    swapped for their plain versions: an MoE model's routing is recorded
    on both routes (``compare_routes``); the prefill logits and cache of
    the rows routed alike (every row of a dense model) are held to
    LOGIT_TOL and CACHE_RTOL / CACHE_ATOL (a mamba layer's float32 ``h``
    to H_CACHE_TOL), greedy tokens by their margins. A first prefill
    warms up and must equal the timed one's routing and logits bit for
    bit. Returns the flash launches, the detail (every launch count in
    ``launches``), and the model, parameters, prompts and LM recorder."""
    from repro_torch.models import transformer as tf
    _, model_zoo, engine_mod = lm
    s_max = LM_PROMPT + LM_NEW
    L = cfg.n_layers
    pat, G = tf.layer_pattern(cfg), tf.n_groups(cfg)
    # the layer of each cache slice [g] of position p<i>; the MoE layers
    # in routing-call order
    layer = {f"p{i}": [g * len(pat) + i for g in range(G)]
             for i in range(len(pat))}
    moe_layers = sorted(x for i, (_, ml) in enumerate(pat) if ml == "moe"
                        for x in layer[f"p{i}"])
    want = {k: G * sum(mx == m for mx, _ in pat)
            for k, m in (("flash_attention", "attn"),
                         ("selective_scan", "mamba"))}
    want = {k: n for k, n in want.items() if n}
    model = model_zoo.build(cfg, s_max=s_max)
    t0 = time.perf_counter()
    params = model.init(LM_SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = engine_mod.ServeEngine(model, params, s_max=s_max)
    prompts = np.random.RandomState(LM_SEED).randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    rec, routes = LMRecorder(model, ops, ref), RouteRecorder(moe_mod)
    # a first prefill warms the path up; its routing and logits must equal
    # the timed run's bit for bit (the determinism remat relies on)
    routes.start()
    with torch.no_grad():
        first, _ = model.prefill_fn(params, {"tokens": prompts})
    torch.cuda.synchronize()
    twice = routes.stop()

    ops.reset_launches()
    rec.start()
    routes.start()
    t1 = time.perf_counter()
    tokens = engine.generate_batch(prompts, LM_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t1
    counts = ops.launches()
    kroute = routes.stop()
    kern = rec.stop()
    check(all(counts[k] == n for k, n in want.items())
          and sum(counts.values()) == sum(want.values()),
          f"{label}: the generation launched {counts}, not {want} (one "
          f"launch a layer that runs the kernel)")
    check(tokens.shape == (LM_BATCH, LM_NEW)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{label}: generated tokens out of range or of shape "
          f"{tokens.shape}")

    rec.start(plain_flash=True)
    routes.start()
    tokens_plain = engine.generate_batch(prompts, LM_NEW)
    torch.cuda.synchronize()
    proute = routes.stop()
    plain = rec.stop()

    (lk, ck), (lp, cp) = kern["prefill"], plain["prefill"]
    R = len(twice)      # routing calls a forward: one an MoE layer
    check(R == len(moe_layers), f"{label}: {R} routing calls in a prefill "
                                f"of {len(moe_layers)} MoE layers")
    check(same_routing(torch, twice, kroute[:R]) and torch.equal(first, lk),
          f"{label}: two prefills of the same prompts routed or computed "
          f"differently")

    check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
    scale = float(lp.abs().max())
    steps = [lp] + plain["steps"]
    marg = torch.stack([margins(torch, st, cfg.vocab_size) for st in steps],
                       1).cpu().numpy()
    cmp = compare_routes(torch, kroute, proute, tokens, tokens_plain, marg,
                         scale, R)
    held = [r for r in range(LM_BATCH)
            if cmp["first"][r] is None or cmp["first"][r] >= R]
    logit_err = max([float((lk[r] - lp[r]).abs().max()) for r in held],
                    default=0.0)
    check(logit_err <= LOGIT_TOL * scale,
          f"{label}: prefill logits: kernel route vs plain differ by "
          f"{logit_err} (> {LOGIT_TOL} x {scale}) on rows routed alike")
    # a layer's cache is computed from its input, which an MoE flip only
    # reaches in later layers
    cache_err, cache_rel = {}, {}
    specs = tf.cache_specs(cfg, LM_BATCH, LM_PROMPT, torch.bfloat16)
    for pos in ck:
        for name in ck[pos]:
            a, b = ck[pos][name], cp[pos][name]
            shape, dt = specs[pos][name]
            check(a.dtype == dt and tuple(a.shape) == shape,
                  f"{label}: cache {pos}.{name}: {a.dtype} "
                  f"{tuple(a.shape)}, not {dt} {shape}")
            top = float(b.abs().max())
            atol, rtol = ((H_CACHE_TOL * top, 0.0) if name == "h"
                          else (CACHE_ATOL * top, CACHE_RTOL))
            for r in range(LM_BATCH):
                f = cmp["first"][r]
                last = L if f is None or f >= R else moe_layers[f]
                gs = [g for g, x in enumerate(layer[pos]) if x <= last]
                if not gs:
                    continue
                ok, err = close(a[gs, r], b[gs, r], atol, rtol)
                check(ok, f"{label}: prefill cache {pos}.{name} row {r}: "
                          f"kernel route vs plain differ by {err} (the "
                          f"leaf's largest magnitude {top:.4g})")
                cache_err[name] = max(cache_err.get(name, 0.0), err)
                rel = cache_rel.setdefault(f"{pos}.{name}", [])
                rel.append(err / max(top, 1e-30))
    n_tok = LM_BATCH * LM_NEW
    decode_s = t_gen - kern["prefill_s"]
    detail = {"arch": cfg.name, "n_layers": L, "n_params": model.n_params(),
              "init_s": t_init, "generate_s": t_gen,
              "prefill_s": kern["prefill_s"],
              "prefill_plain_flash_s": plain["prefill_s"],
              "decode_s": decode_s,
              "decode_ms_per_step": decode_s * 1e3 / (LM_NEW - 1),
              "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / kern["prefill_s"],
              "flash_launches": counts["flash_attention"],
              "launches": {k: counts[k] for k in want},
              "logit_err": logit_err, "logit_scale": scale,
              "rows_held": held, "cache_err": cache_err,
              "cache_err_over_scale": cache_rel,
              "routing": {k: v for k, v in cmp.items()},
              "tokens": tokens.tolist(), "tokens_plain": tokens_plain.tolist(),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    pre = [f["gap"] for f in cmp["flips"] if f["call"] < R]
    dec = [f["gap"] for f in cmp["flips"] if f["call"] >= R]
    say(f"{label} serve {cfg.name} ({L} layers, "
        f"{model.n_params() / 1e9:.3f} B params fp32, init {t_init:.2f} s): "
        f"{LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_NEW} new, "
        f"{t_gen:.2f} s (prefill {kern['prefill_s']:.3f} s, plain-flash "
        f"prefill {plain['prefill_s']:.3f} s, decode "
        f"{detail['decode_ms_per_step']:.1f} ms per step); launches "
        + ", ".join(f"{k} {counts[k]}" for k in want) + "; "
        + (f"routing: {cmp['decisions']} decisions compared, tokens routed "
           f"differently between the routes: {len(pre)} in the prefill "
           f"(gaps {[float(f'{g:.3g}') for g in pre]}), {len(dec)} in "
           f"decode steps (gaps {[float(f'{g:.3g}') for g in dec]}); the "
           f"routes' probabilities drift by up to "
           f"{cmp['drift']['prefill']:.3g} (prefill) and "
           f"{cmp['drift']['decode']:.3g} (decode) of the K-th at tokens "
           f"routed alike; smallest K-th/(K+1)-th gap "
           f"{cmp['min_gap']:.3g}; " if R else "")
        + "two prefills routed and computed bit for bit alike; logits max "
        f"err "
        f"{logit_err:.3g} (scale {scale:.3g}) on rows {held}, cache max err "
        + ", ".join(f"{k} {e:.3g}" for k, e in cache_err.items())
        + f", {cmp['tokens_compared']} of {n_tok} greedy "
        f"tokens equal, {cmp['rows_split_at_small_margin']} rows split at "
        f"margins <= tolerance")
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


def phase_profile(torch, model, params, prompts, fork, fork_fn,
                  label="phase 11"):
    """Where a full-width prefill's, a decode step's (on the cache
    ``fork``) and a fork's time goes (no fork when ``fork_fn`` is None):
    device time by kernel and the device's busy share of the wall time,
    over enough back-to-back calls to span ``DEVICE_WINDOW_MS`` (a lone
    fork's profile came back empty)."""
    out = {}
    with torch.no_grad():
        runs = {"prefill": lambda: model.prefill_fn(params,
                                                    {"tokens": prompts}),
                "decode": lambda: model.decode_fn(
                    params, fork, torch.zeros(
                        (next(iter(fork["p0"].values())).shape[1], 1),
                        dtype=torch.long,
                        device=params["embed"].device),
                    LM_PROMPT + LM_NEW - 1)}
        if fork_fn is not None:
            runs["fork"] = fork_fn
        for name, fn in runs.items():
            calls = max(1, math.ceil(DEVICE_WINDOW_MS / max(
                cuda_ms(fn, reps=1), 1e-3)))
            rows, wall = profile_rows(torch,
                                      lambda: [fn() for _ in range(calls)])
            busy = sum(ms for _, ms, _ in rows)
            out[name] = {"calls": calls, "wall_ms": wall / calls,
                         "device_ms": busy / calls, "busy_share": busy / wall,
                         "kernels": rows}
            say(f"{label} {name} profile ({calls} calls): wall "
                f"{wall / calls:.2f} ms, device busy {busy / calls:.2f} ms "
                f"({100 * busy / wall:.1f}%) per call; over all calls: "
                + ", ".join(f"{k[:48]} {ms:.3f} ms x{n}"
                            for k, ms, n in rows[:5]))
    return out


def phase_fork(torch, ops, dev, lm, model, params, prompts,
               label="phase 10"):
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
    # the attention k / v go through the kernel; mamba states are tiled
    n_leaves = sum(t.dim() == 5 for v in cache.values() for t in v.values())
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
    leaf = next(t for v in cache.values() for t in v.values() if t.dim() == 5)
    say(f"{label} fork: {FORK_N}-way fork of a {LM_PROMPT}-token cache "
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


# ---------------- phase 13: training ----------------

def train_cut(cut):
    """(config, batch, tokens a row) of a CPU-checked training cut:
    ``"small"`` is launch.train's small preset of TRAIN_ARCH (13a),
    ``"hybrid"`` one pattern period of HYBRID_ARCH at the small preset's
    widths with its MoE's expert d_ff cut to the small d_ff (15c)."""
    from repro_torch.launch.train import PRESETS, preset_config
    if cut == "small":
        return (preset_config(TRAIN_ARCH, "small"), TRAIN_SMALL_BATCH,
                TRAIN_SMALL_SEQ)
    from repro_torch import configs
    small = dict(PRESETS["small"], n_layers=HYBRID_LAYERS)
    cfg = configs.get_config(HYBRID_ARCH)
    cfg = cfg.scaled(**small, moe=dataclasses.replace(cfg.moe,
                                                      d_ff=small["d_ff"]))
    return cfg, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ


def small_train_run(device, compute, steps=TRAIN_SMALL_STEPS, grads=None,
                    cut="small", times=None):
    """The training cut ``cut`` (``train_cut``) on ``device``: fp32
    masters drawn on the CPU from TRAIN_SEED (the same on every device),
    then ``steps`` AdamW steps (launch.train's TRAIN_SMALL_OPT) at the
    ``compute`` dtype over SyntheticLM batches. Returns the state and
    each step's metrics as floats; each step's gradient leaves (before
    clipping, as host float32 arrays) are appended to ``grads`` when it
    is a list, each step's synchronized milliseconds to ``times``."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model_zoo, pdefs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step
    cfg, batch, seq = train_cut(cut)
    model = model_zoo.build(cfg, s_max=seq)
    params = pdefs.tree_map(lambda t: t.to(device),
                            model.init(TRAIN_SEED, device="cpu"))
    state = opt.init_state(params)

    def keep(g):
        grads.append([t.detach().float().cpu().numpy()
                      for t in pdefs.tree_leaves(g)])
        return g
    step = make_train_step(model, opt.AdamWConfig(**TRAIN_SMALL_OPT),
                           compute_dtype=getattr(torch, compute),
                           grad_compressor=None if grads is None else keep)
    src = SyntheticLM(cfg.vocab_size, seq, batch, seed=TRAIN_SEED)
    metrics = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, src.batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
        if times is not None:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return state, metrics


def train_cpu_job(cut="small"):
    """The CPU side of a training check (13a, 15c), in a worker process:
    the cut's float32 run, and for 13a the bf16 run. Its master, m and v
    and each step's gradients go to ``.npy`` files in a temporary
    directory (``out["dir"]``; ``load_cpu_arrays`` maps them), not
    through the pool's pipe, which moves ~0.1 GB/s. It leaves two cores
    to the card's launching thread."""
    import tempfile
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    from repro_torch.models import pdefs
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - 2))
    t0 = time.perf_counter()
    grads = []
    state, metrics = small_train_run("cpu", "float32", grads=grads, cut=cut)
    out = {"float32": metrics,
           "dir": tempfile.mkdtemp(prefix="chip_smoke_cpu_")}

    def dump(arrays, tag):
        paths = [os.path.join(out["dir"], f"{tag}_{i}.npy")
                 for i in range(len(arrays))]
        for path, a in zip(paths, arrays):
            np.save(path, a)
        return paths
    out["state"] = {name: dump([t.numpy() for t in pdefs.tree_leaves(
        getattr(state, name))], name) for name in ("master", "m", "v")}
    out["grads"] = [dump(g, f"grad{i}") for i, g in enumerate(grads)]
    if cut == "small":
        _, out["bfloat16"] = small_train_run("cpu", "bfloat16")
    out["s"] = time.perf_counter() - t0
    return out


def load_cpu_arrays(np, cpu):
    """``train_cpu_job``'s result with its array files memory-mapped."""
    cpu = dict(cpu)
    load = lambda paths: [np.load(p, mmap_mode="r") for p in paths]  # noqa: E731
    cpu["state"] = {name: load(p) for name, p in cpu["state"].items()}
    cpu["grads"] = [load(p) for p in cpu["grads"]]
    return cpu


def card_train_f32(dev, cut):
    """The cut's float32 steps on the card: (metrics, master / m / v as
    numpy, each step's gradients, the leaf names)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import pdefs
    grads = []
    state, metrics = small_train_run(dev, "float32", grads=grads, cut=cut)
    card = {name: [t.cpu().numpy() for t in
                   pdefs.tree_leaves(getattr(state, name))]
            for name in ("master", "m", "v")}
    return metrics, card, grads, list(ckpt._flatten(state.master))


def compare_train(np, label, card32, card, card_grads, names, cpu):
    """The card's float32 steps against the CPU's at 13a's rules (lr
    equal, loss and grad norm within TRAIN_F32_RTOL, m and v within
    TRAIN_MV_TOL of each leaf's largest, the masters in units of the
    summed lr). Returns (the errors, sum(lr), the masters' tail rows)."""
    sum_lr = sum(m["lr"] for m in card32)
    for a, b in zip(card32, cpu["float32"]):
        check(a["lr"] == b["lr"], f"{label}: lr {a['lr']} != CPU {b['lr']}")
        for k in ("loss", "grad_norm"):
            check(abs(a[k] - b[k]) <= TRAIN_F32_RTOL * abs(b[k]),
                  f"{label}: float32 {k} {a[k]} != CPU {b[k]}")
    err = {}
    for name in ("m", "v"):
        worst = 0.0
        for g, w in zip(card[name], cpu["state"][name]):
            scale = max(float(np.abs(w).max()), 1e-30)
            worst = max(worst, float(np.abs(g - w).max()) / scale)
        err[name] = worst
        check(worst <= TRAIN_MV_TOL, f"{label}: float32 {name} differs from "
              f"the CPU run by {worst:.3g} of a leaf's largest")
    # masters in units of the summed lr: Adam moves an element by at most
    # ~lr a step whatever its gradient, so an element whose gradient is
    # at the rounding noise may differ by up to 2 sum(lr); the bulk stays
    # within TRAIN_MASTER_LR_TOL
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(
        card["master"], cpu["state"]["master"])]) / sum_lr
    tail = float((d > TRAIN_MASTER_LR_TOL).mean())
    err["master"], err["master_tail"] = float(d.max()), tail
    named = master_tail(np, names, card, cpu["state"], card_grads,
                        cpu["grads"], sum_lr, label=label)
    check(err["master"] <= TRAIN_MASTER_BOUND and tail <= TRAIN_MASTER_TAIL,
          f"{label}: float32 masters differ from the CPU run by up to "
          f"{err['master']:.3g} of sum(lr), {tail:.3g} of them by more than "
          f"{TRAIN_MASTER_LR_TOL}")
    return err, sum_lr, named


def phase_train_small(torch, np, dev, cpu_job):
    """13 (a): the small preset on the card against the port's CPU run on
    the same masters and batches: float32 compute (TF32 off) at the CPU
    tests' tolerances, bf16 losses within TRAIN_BF16_LOSS_RTOL."""
    card32, card, card_grads, names = card_train_f32(dev, "small")
    _, card16 = small_train_run(dev, "bfloat16")
    cpu = cpu_job.get(timeout=300)
    try:
        err, sum_lr, named = compare_train(
            np, "13a", card32, card, card_grads, names,
            load_cpu_arrays(np, cpu))
    finally:
        shutil.rmtree(cpu["dir"], ignore_errors=True)
    for i, (a, b) in enumerate(zip(card16, cpu["bfloat16"])):
        check(math.isfinite(a["loss"]) and abs(a["loss"] - b["loss"])
              <= TRAIN_BF16_LOSS_RTOL * abs(b["loss"]),
              f"13a: bf16 step {i} loss {a['loss']} != CPU {b['loss']}")
    say(f"phase 13a training, small preset ({TRAIN_SMALL_BATCH} x "
        f"{TRAIN_SMALL_SEQ} tokens): {len(card32)} float32 steps on the "
        f"card == the CPU's (master max err {err['master']:.3g} of "
        f"sum(lr), a share {err['master_tail']:.3g} beyond "
        f"{TRAIN_MASTER_LR_TOL} ({len(named)} elements); m {err['m']:.3g} "
        f"and v {err['v']:.3g} of "
        f"each leaf's largest), bf16 losses "
        + ", ".join(f"{a['loss']:.5f}/{b['loss']:.5f}"
                    for a, b in zip(card16, cpu["bfloat16"]))
        + f" (card/CPU); the CPU process took {cpu['s']:.1f} s")
    return {"float32": card32, "bfloat16": card16, "cpu": {
        k: cpu[k] for k in ("float32", "bfloat16", "s")},
        "max_err": err, "sum_lr": sum_lr, "master_tail": named}


def master_tail(np, names, card, cpu, card_grads, cpu_grads, sum_lr,
                most=16, label="13a"):
    """The float32 master elements beyond TRAIN_MASTER_LR_TOL x sum(lr)
    between the card and the CPU (ROADMAP Queue C 1): leaf and index,
    and on both sides the master, m, v, Adam's denominator sqrt(v_hat)
    against eps, and each step's gradient beside the leaf's largest
    gradient magnitude that step. Prints the ``most`` largest; returns
    them all as dicts."""
    from repro_torch.train import optimizer as opt
    ocfg = opt.AdamWConfig(**TRAIN_SMALL_OPT)
    c2 = 1 - ocfg.b2 ** len(card_grads)
    rows = []
    for li, name in enumerate(names):
        diff = np.abs(card["master"][li] - cpu["master"][li]) / sum_lr
        for j in np.flatnonzero(diff.ravel() > TRAIN_MASTER_LR_TOL):
            at = np.unravel_index(j, diff.shape)
            row = {"leaf": name, "index": [int(i) for i in at],
                   "d_over_sum_lr": float(diff[at])}
            for side, st, gs in (("card", card, card_grads),
                                 ("cpu", cpu, cpu_grads)):
                v = float(st["v"][li][at])
                row[side] = {
                    "master": float(st["master"][li][at]),
                    "m": float(st["m"][li][at]), "v": v,
                    "sqrt_v_hat_over_eps": math.sqrt(v / c2) / ocfg.eps,
                    "grads": [float(g[li][at]) for g in gs],
                    "leaf_max_grads": [float(np.abs(g[li]).max())
                                       for g in gs]}
            rows.append(row)
    rows.sort(key=lambda r: -r["d_over_sum_lr"])
    for r in rows[:most]:
        say(f"  {label} tail {r['leaf']}{r['index']}: "
            f"{r['d_over_sum_lr']:.4g} "
            f"of sum(lr); " + "; ".join(
                f"{side} master {r[side]['master']:.7g} m {r[side]['m']:.4g} "
                f"v {r[side]['v']:.4g} sqrt(v_hat)/eps "
                f"{r[side]['sqrt_v_hat_over_eps']:.4g} grads "
                + "/".join(f"{g:.4g}" for g in r[side]["grads"])
                + " (leaf max " + "/".join(
                    f"{g:.3g}" for g in r[side]["leaf_max_grads"]) + ")"
                for side in ("card", "cpu")))
    return rows


def train_flops(cfg, n_params, batch, seq):
    """(model FLOPs a step, the remat recompute's FLOPs, the formula):
    6 N T over the parameters that multiply a token (the embedding is a
    lookup; of an MoE layer's experts only the top k) plus PaLM's
    attention term 12 L H hd S T (the plain path computes the full S x S
    scores); remat runs each layer's forward again (2 N T without the
    head, 4 L H hd S T), the chunked CE the head's, and the checkpointed
    query blocks of S > 1024 the attention once more."""
    from repro_torch.models import transformer as tf
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    T = batch * seq
    n_mm = n_params - (0 if cfg.tie_embeddings
                       else cfg.padded_vocab * cfg.d_model)
    if cfg.moe is not None:
        m = cfg.moe
        moe_layers = tf.n_groups(cfg) * sum(
            ml == "moe" for _, ml in tf.layer_pattern(cfg))
        mats = 3 if cfg.act in ("swiglu", "geglu") else 2
        n_mm -= moe_layers * (m.n_experts - m.top_k) * mats * cfg.d_model \
            * m.d_ff
    attn = 4 * L * H * hd * seq * T            # one forward's scores + PV
    model = 6 * n_mm * T + 3 * attn
    recompute = 2 * n_mm * T + attn * (2 if seq > 1024 else 1)
    formula = (f"6 N T + 12 L H hd S T = 6 x {n_mm} x {T} + 12 x {L} x {H} "
               f"x {hd} x {seq} x {T}"
               + (" (N: the top-k experts' share of each MoE layer)"
                  if cfg.moe is not None else "")
               + f"; remat recompute 2 N T + "
               f"{'8' if seq > 1024 else '4'} L H hd S T")
    return model, recompute, formula


def train_run(torch, ops, dev, cfg, batch, steps, timed):
    """``cfg`` at full width: fp32 masters from TRAIN_SEED, bf16 compute,
    remat, AdamW at TRAIN_LR with TRAIN_WARMUP; ``steps`` steps over
    SyntheticLM batches of ``batch`` x TRAIN_SEQ tokens with the launch
    counters and the peak memory reset just before, the last ``timed``
    timed, then one profiled step. Returns (model, state, step, src,
    out). Raises torch.cuda.OutOfMemoryError when it does not fit."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step
    model = model_zoo.build(cfg, s_max=TRAIN_SEQ)
    t0 = time.perf_counter()
    state = opt.init_state(model.init(TRAIN_SEED, device=dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP)
    step = make_train_step(model, ocfg)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, batch, seed=TRAIN_SEED)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for i in range(steps):
        b = src.batch(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    check(all(map(math.isfinite, losses + norms)),
          f"{cfg.name}: non-finite loss or grad norm: {losses} {norms}")
    box = {}
    b = src.batch(steps)
    rows, wall = profile_rows(torch, lambda: box.update(r=step(state, b)))
    state, m = box.pop("r")
    check(math.isfinite(float(m["loss"])),
          f"{cfg.name}: profiled step non-finite")
    busy = sum(ms for _, ms, _ in rows)
    timed_ms = sorted(times[-timed:])
    med = (timed_ms[(timed - 1) // 2] + timed_ms[timed // 2]) / 2
    flops, recompute, formula = train_flops(cfg, model.n_params(), batch,
                                            TRAIN_SEQ)
    out = {
        "arch": cfg.name, "n_params": model.n_params(), "batch": batch,
        "seq": TRAIN_SEQ, "tokens_per_step": batch * TRAIN_SEQ,
        "init_s": init_s, "step_ms": times, "timed": timed,
        "step_ms_median": med,
        "step_ms_min": timed_ms[0], "step_ms_max": timed_ms[-1],
        "tokens_per_s": batch * TRAIN_SEQ / (med / 1e3),
        "peak_mem_gb": peak / 1e9, "losses": losses, "grad_norms": norms,
        "moe_aux": [m["moe_aux"] for m in metrics],
        "moe_z": [m["moe_z"] for m in metrics],
        "profiled_wall_ms": wall, "profiled_device_ms": busy,
        "busy_share": busy / wall, "top_ops": rows[:12],
        "model_flops": flops, "recompute_flops": recompute,
        "flops_formula": formula,
        "mfu": flops / (med / 1e3) / BF16_PEAK_OPS_PER_S,
        "hfu": (flops + recompute) / (med / 1e3) / BF16_PEAK_OPS_PER_S}
    return model, state, step, src, out


def full_train_run(torch, ops, dev, batch):
    """13 (b) at one batch size: TRAIN_STEPS steps, the last TRAIN_TIMED
    timed, one profiled step, microbatches 2 against 1, one int8_wire
    step. Raises torch.cuda.OutOfMemoryError when it does not fit."""
    from repro_torch import configs
    from repro_torch.models import pdefs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import make_train_step
    model, state, _, src, out = train_run(
        torch, ops, dev, configs.get_config(TRAIN_ARCH), batch, TRAIN_STEPS,
        TRAIN_TIMED)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP)
    # microbatches 2 against 1 on one batch: the k=1 loss is the forward
    # the k=1 step would take on these masters
    b = src.batch(TRAIN_STEPS + 1)
    with torch.no_grad():
        p16 = pdefs.tree_map(lambda x: x.to(torch.bfloat16), state.master)
        loss1 = float(model.loss_fn(p16, b)[0])
        del p16
    state, m2 = make_train_step(model, ocfg, num_microbatches=2)(state, b)
    loss2 = float(m2["loss"])
    check(abs(loss2 - loss1) <= TRAIN_MB_LOSS_RTOL * abs(loss1),
          f"13b: 2 microbatches' loss {loss2} against one batch's {loss1}")
    state, m8 = make_train_step(model, ocfg, grad_compressor="int8_wire")(
        state, src.batch(TRAIN_STEPS + 2))
    gn8 = float(m8["grad_norm"])
    check(math.isfinite(gn8) and math.isfinite(float(m8["loss"])),
          f"13b: int8_wire step: grad norm {gn8}")
    torch.cuda.synchronize()
    counts = ops.launches()
    check(all(n == 0 for n in counts.values()),
          f"13b: the training steps launched kernels: {counts}")
    out.update({"microbatch": {"loss_k1": loss1, "loss_k2": loss2,
                               "grad_norm_k2": float(m2["grad_norm"])},
                "int8_wire": {"loss": float(m8["loss"]), "grad_norm": gn8},
                "launches": counts})
    return out


def fit_batch(torch, run, label):
    """``run(batch)`` at TRAIN_BATCH, halved while it does not fit on the
    card (widths and depth never cut); the cut is printed."""
    for batch in (TRAIN_BATCH, TRAIN_BATCH // 2, 1):
        try:
            out = run(batch)
        except torch.cuda.OutOfMemoryError:
            out = None
        if out is not None:
            out["batch_cut"] = out["batch"] != TRAIN_BATCH
            return out
        gc.collect()
        torch.cuda.empty_cache()
        say(f"{label}: batch {batch} x {TRAIN_SEQ} does not fit on the "
            f"card; the batch is cut")
    raise CheckFailed(f"{label}: the model does not train at batch 1")


def train_summary(t):
    """The timed steps' line shared by 13b and 14c."""
    return (f"({t['n_params'] / 1e9:.3f} B params, fp32 masters, bf16 "
            f"compute, remat) at {t['batch']} x {t['seq']} tokens"
            + (" (batch cut)" if t["batch_cut"] else "")
            + f": step {t['step_ms_median']:.1f} ms median of the last "
            f"{t['timed']} ({t['step_ms_min']:.1f}-{t['step_ms_max']:.1f}), "
            f"{t['tokens_per_s']:.0f} tokens/s, peak {t['peak_mem_gb']:.2f} "
            f"GB; loss {t['losses'][0]:.4f} -> {t['losses'][-1]:.4f}; "
            f"profiled step wall {t['profiled_wall_ms']:.1f} ms, device busy "
            f"{100 * t['busy_share']:.1f}%; model FLOPs "
            f"{t['model_flops']:.4g} ({t['flops_formula']}), "
            f"{100 * t['mfu']:.2f}% of the bf16 dense peak "
            f"({BF16_PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s), with the "
            f"recompute ({t['recompute_flops']:.4g}) {100 * t['hfu']:.2f}%")


def phase_train_full(torch, ops, dev):
    """13 (b): qwen2-1.5b at full width and depth; a batch that does not
    fit is halved (widths and depth never cut) and the cut printed."""
    t = fit_batch(torch, lambda b: full_train_run(torch, ops, dev, b),
                  "phase 13b")
    say(f"phase 13b training {TRAIN_ARCH} full width and depth "
        + train_summary(t)
        + f"; 2 microbatches' loss {t['microbatch']['loss_k2']:.5f} against "
        f"{t['microbatch']['loss_k1']:.5f}; int8_wire grad norm "
        f"{t['int8_wire']['grad_norm']:.4g}; kernel launches "
        f"{t['launches']}")
    say("phase 13b top device ops (profiled step): " + ", ".join(
        f"{k[:56]} {ms:.2f} ms x{n}" for k, ms, n in t["top_ops"][:8]))
    return t


def phase_train_resume(torch, np, dev):
    """13 (c): at the small preset, 6 steps straight against 3, save,
    restore, 3 (rtol 1e-5, atol 1e-6, the reference's resume test); an
    async save at step 3 equals the step-3 state while the next steps
    update that state in place."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import ShardedLoader, SyntheticLM
    from repro_torch.launch.train import preset_config
    from repro_torch.models import model_zoo, pdefs
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer
    cfg = preset_config(TRAIN_ARCH, "small")
    model = model_zoo.build(cfg, s_max=TRAIN_SMALL_SEQ)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup=2, total_steps=50)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SMALL_SEQ, TRAIN_SMALL_BATCH,
                      seed=2)
    tr = Trainer(model, ocfg, device=dev)
    s_ref, _ = tr.run(tr.init_state(seed=3), iter(ShardedLoader(src)),
                      steps=6, log_every=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        tr2 = Trainer(model, ocfg, ckpt_dir=tmp, ckpt_every=1000, device=dev)
        s, _ = tr2.run(tr2.init_state(seed=3), iter(ShardedLoader(src)),
                       steps=3, log_every=0)
        snap = [t.cpu().clone() for t in pdefs.tree_leaves(s.master)]
        th = ckpt.save(tmp, s, int(s.step), async_=True)
        s, _ = tr2.run(s, iter(ShardedLoader(src, start_step=3)), steps=3,
                       log_every=0)
        th.join(timeout=120)
        check(not th.is_alive(), "13c: the async save did not finish")
        restored = ckpt.restore_latest(tmp)
        step0 = restored.pop("__step__")
        check(step0 == 3, f"13c: restored step {step0}")
        for name, want in zip(ckpt._flatten(s.master), snap):
            check(np.array_equal(restored[".master__" + name], want.numpy()),
                  f"13c: the async save of step 3 holds a later {name}")
        s2 = ckpt.load_into(restored, tr2.init_state(seed=3))
        s2, _ = tr2.run(s2, iter(ShardedLoader(src, start_step=step0)),
                        steps=3, log_every=0)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst = 0.0
    for a, b in zip(pdefs.tree_leaves(s_ref.master),
                    pdefs.tree_leaves(s2.master)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        check(np.allclose(b, a, rtol=1e-5, atol=1e-6),
              f"13c: resumed master differs from 6 straight steps by "
              f"{float(np.abs(a - b).max())}")
        worst = max(worst, float(np.abs(a - b).max()))
    check(int(s2.step) == 6, f"13c: resumed to step {int(s2.step)}")
    say(f"phase 13c resume, small preset: 3 steps + async save + restore + "
        f"3 == 6 straight (max abs err {worst:.3g}); the async save of step "
        f"3 is step 3's state while 3 later steps updated it in place "
        f"({resume_s:.2f} s)")
    return {"max_abs_err": worst, "s": resume_s}


def phase_train_cli(torch):
    """13 (d): ``python -m repro_torch.launch.train`` on the card at the
    tiny preset: 30 steps with the loss falling, then a second call to
    40 steps resuming from the step-25 checkpoint."""
    import re
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    runs = []
    try:
        for steps in (30, 40):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 TRAIN_ARCH, "--preset", "tiny", "--steps", str(steps),
                 "--ckpt", tmp], capture_output=True, text=True, timeout=600,
                env=env, cwd=ROOT)
            runs.append({"steps": steps, "rc": r.returncode,
                         "s": time.perf_counter() - t0,
                         "stdout": r.stdout[-4000:],
                         "stderr": r.stderr[-4000:]})
            check(r.returncode == 0, f"13d: launch.train --steps {steps} "
                                     f"exited {r.returncode}: {r.stderr[-800:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first, second = runs[0]["stdout"], runs[1]["stdout"]
    name = torch.cuda.get_device_name(0)
    check(f"device={name}" in first, "13d: launch.train did not run on the "
                                     "card")
    m = re.search(r"loss ([0-9.]+) -> ([0-9.]+)", first)
    check(m is not None and float(m.group(2)) < float(m.group(1)),
          f"13d: the loss did not fall: {first[-400:]}")
    check("resumed from step 25" in second,
          f"13d: the second call did not resume from step 25: "
          f"{second[-400:]}")
    say(f"phase 13d launch.train CLI on the card: --steps 30 loss "
        f"{m.group(1)} -> {m.group(2)} in {runs[0]['s']:.1f} s; --steps 40 "
        f"resumed from step 25 in {runs[1]['s']:.1f} s")
    return runs


def phase_train(torch, np, ops, dev):
    """Phase 13, training; (a)'s CPU run goes on in a worker process
    beside (c) and (d), after (b)'s timed steps, and is compared last."""
    out = {"full": phase_train_full(torch, ops, dev)}
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        cpu_job = pool.apply_async(train_cpu_job)
        out["resume"] = phase_train_resume(torch, np, dev)
        out["cli"] = phase_train_cli(torch)
        out["small"] = phase_train_small(torch, np, dev, cpu_job)
    finally:
        pool.terminate()
        pool.join()
    return out


# ---------------- phase 14: MoE ----------------

def moe_flash(torch, ops, ref, rec, label):
    """The flash kernel on the first MoE prefill layer's inputs (head dim
    64) against its plain version, and its time beside SDPA's."""
    q, k, v, causal = rec.flash_args
    kern = rec.orig[2]
    got, want = kern(q, k, v, causal), ref.flash_attention_ref(q, k, v, causal)
    ok, err = close(got, want, FLASH_TOL["float32"], FLASH_TOL["float32"])
    check(ok, f"{label}: flash_attention != plain on the prefill's inputs "
              f"(max abs err {err})")
    out = {"shape": f"q {list(q.shape)}, k/v {list(k.shape)} {q.dtype}",
           "max_abs_err": err,
           "ms": cuda_ms(lambda: kern(q, k, v, causal), reps=10),
           "sdpa_ms": cuda_ms(lambda: sdpa_call(torch, q, k, v, causal),
                              reps=10)}
    say(f"{label} flash_attention at {out['shape']}: == plain (max abs err "
        f"{err:.3g}), {out['ms']:.4f} ms per call (SDPA "
        f"{out['sdpa_ms']:.4f} ms)")
    return out


def moe_train_run(torch, ops, dev, moe_mod, batch):
    """14 (c) at one batch size: MOE_ARCH trained as 13b, then two
    forwards of the loss on one batch route bit for bit alike."""
    from repro_torch import configs
    from repro_torch.models import pdefs
    model, state, _, src, out = train_run(
        torch, ops, dev, configs.get_config(MOE_ARCH), batch,
        MOE_TRAIN_STEPS, MOE_TRAIN_TIMED)
    b = src.batch(MOE_TRAIN_STEPS + 1)
    routes = RouteRecorder(moe_mod)
    runs = []
    with torch.no_grad():
        p16 = pdefs.tree_map(lambda x: x.to(torch.bfloat16), state.master)
        for _ in range(2):
            routes.start()
            loss = model.loss_fn(p16, b)[0]
            torch.cuda.synchronize()
            runs.append((routes.stop(), loss))
        del p16
    check(len(runs[0][0]) == model.cfg.n_layers
          and same_routing(torch, runs[0][0], runs[1][0])
          and torch.equal(runs[0][1], runs[1][1]),
          "14c: two bf16 forwards of one batch routed or computed "
          "differently")
    counts = ops.launches()
    check(all(n == 0 for n in counts.values()),
          f"14c: the training steps launched kernels: {counts}")
    out["launches"] = counts
    return out


def phase_moe(torch, np, ops, ref, dev, lm, moe_mod):
    """Phase 14: (a) MOE_ARCH served, forked and profiled, (b)
    MOE_BIG_ARCH at MOE_BIG_LAYERS layers served, (c) MOE_ARCH trained.
    Returns the detail with the flash and rowclone launches of (a) and
    (b)."""
    configs, _, engine_mod = lm
    t_phase = time.perf_counter()
    out = {}
    cfg = configs.get_config(MOE_ARCH)
    flash_n, out["serve"], model, params, prompts, rec = phase_serve(
        torch, np, ops, ref, dev, lm, moe_mod, cfg, "phase 14a")
    out["flash_hd64"] = moe_flash(torch, ops, ref, rec, "phase 14a")
    rc_n, out["fork"], cache1, fork = phase_fork(
        torch, ops, dev, lm, model, params, prompts, label="phase 14a")
    fork_engine = engine_mod.ServeEngine(model, params, model.s_max)
    out["profile"] = phase_profile(
        torch, model, params, prompts, fork,
        lambda: fork_engine.fork_cache(cache1, FORK_N), label="phase 14a")
    del model, params, rec, cache1, fork, fork_engine
    gc.collect()
    torch.cuda.empty_cache()

    big = configs.get_config(MOE_BIG_ARCH).scaled(n_layers=MOE_BIG_LAYERS)
    n, out["serve_big"], model, params, prompts, rec = phase_serve(
        torch, np, ops, ref, dev, lm, moe_mod, big, "phase 14b")
    flash_n += n
    cache = engine_mod.pad_cache_to(rec.run["prefill"][1], model.s_max)
    out["profile_big"] = phase_profile(torch, model, params, prompts, cache,
                                       None, label="phase 14b")
    del model, params, rec, cache
    gc.collect()
    torch.cuda.empty_cache()

    t = out["train"] = fit_batch(
        torch, lambda b: moe_train_run(torch, ops, dev, moe_mod, b),
        "phase 14c")
    say(f"phase 14c training {MOE_ARCH} full width and depth "
        + train_summary(t)
        + f"; moe_aux {t['moe_aux'][0]:.5f} -> {t['moe_aux'][-1]:.5f}, "
        f"moe_z {t['moe_z'][0]:.5f} -> {t['moe_z'][-1]:.5f} (first and last "
        f"step); two bf16 forwards routed bit for bit alike; kernel "
        f"launches {t['launches']}")
    say("phase 14c top device ops (profiled step): " + ", ".join(
        f"{k[:56]} {ms:.2f} ms x{n}" for k, ms, n in t["top_ops"][:8]))
    out.update(flash_launches=flash_n, rowclone_launches=rc_n,
               seconds=time.perf_counter() - t_phase)
    say(f"phase 14 MoE: {out['seconds']:.1f} s; flash_attention launches "
        f"{flash_n}, rowclone_copy launches {rc_n}")
    return out


# ---------------- phase 15: the mamba hybrid ----------------

def ssm_case(torch, B, S, di, N, device, seed=0):
    """Seeded ``ops.selective_scan`` inputs on ``device``: u, B, C, D
    standard normal, dt = softplus(normal - 1), A = -exp(log(n + 1) +
    0.1 normal) (the hippo init, perturbed), h0 0.3 normal."""
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(seed + B + S + di + N)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device)
    n = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return (r(B, S, di), F.softplus(r(B, S, di) - 1.0), r(B, S, N),
            r(B, S, N), -torch.exp(torch.log(n) + 0.1 * r(di, N)), r(di),
            0.3 * r(B, di, N))


def ssm_errors(torch, got, want):
    """y's and hT's largest difference over their largest magnitude."""
    return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


def phase_ssm_kernel(torch, ops, ref, dev, args, launches):
    """15 (b): ``selective_scan`` against its plain version on SSM_CASES
    and on the prefill's first call's inputs ``args``, where it is timed
    beside the plain version, with its bound. Returns the kernel line's
    entry."""
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    worst = 0.0
    for shape in SSM_CASES + ["the prefill's inputs"]:
        case = args if isinstance(shape, str) else ssm_case(
            torch, *shape, dev)
        errs = ssm_errors(torch, selective_scan_cuda(*case),
                          ref.selective_scan_ref(*case))
        check(max(errs) <= SSM_TOL,
              f"selective_scan != plain at {shape}: y and hT differ by "
              f"{errs} of their largest (> {SSM_TOL})")
        worst = max(worst, *errs)
    u, dt, Bm, Cm, A, D, h0 = args
    B, S, di = u.shape
    N = A.shape[-1]
    got = selective_scan_cuda(*args)
    want = ref.selective_scan_ref(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # u and dt read, y written: B S di float32 each; B, C read; A, D
    # read; h0 read and hT written. Per (b, t, d, n): dt A, exp, times h,
    # plus (dt u) B, times C, plus into y: 7 operations, and dt u once
    nbytes = 4 * (3 * B * S * di + 2 * B * S * N + di * N + di
                  + 2 * B * di * N)
    nops = B * S * di * (7 * N + 1)
    bms, bby = bound_ms(nbytes, nops)
    kern = lambda: selective_scan_cuda(*args)     # noqa: E731
    entry = {
        "name": "selective_scan", "route": "cuda",
        "source": SOURCES["selective_scan"],
        "replaces": REPLACES["selective_scan"], "launches": launches,
        "max_abs_err": err, "max_rel_err_grid": worst,
        "ms": cuda_ms(kern, reps=10),
        "plain_ms": cuda_ms(lambda: ref.selective_scan_ref(*args), reps=2),
        "bound_ms": bms, "bound_by": bby, "library_ms": None,
        **device_fields(kern, "selective_scan_kernel"),
        "shape": f"u / dt / y {list(u.shape)}, B / C {list(Bm.shape)}, "
                 f"d_state {N} (one prefill layer)",
        "bytes": nbytes, "flops": nops}
    say(f"phase 15b selective_scan: == plain on {len(SSM_CASES) + 1} cases "
        f"(largest difference {worst:.3g} of the largest |y| / |hT| <= "
        f"{SSM_TOL}); at {entry['shape']}: {entry['ms']:.4f} ms per call, "
        f"device {entry['device_ms']:.4f} ms per launch "
        f"({entry['device_ms_method']}), plain {entry['plain_ms']:.2f} ms, "
        f"bound {bms:.4f} ms by {bby} ({nbytes / 1e9:.3f} GB); "
        f"{launches} launches on the path")
    return entry


def phase_hybrid_train(torch, np, ops, dev, cpu_job):
    """15 (c): the hybrid training cut's float32 steps on the card
    against the CPU process's at 13a's rules, then HYBRID_BF16_STEPS bf16
    steps timed; no kernel launched by any step."""
    ops.reset_launches()
    card32, card, card_grads, names = card_train_f32(dev, "hybrid")
    times = []
    _, card16 = small_train_run(dev, "bfloat16", steps=HYBRID_BF16_STEPS,
                                cut="hybrid", times=times)
    counts = ops.launches()
    check(all(n == 0 for n in counts.values()),
          f"15c: the training steps launched kernels: {counts}")
    check(all(math.isfinite(m["loss"]) for m in card16),
          f"15c: bf16 losses {[m['loss'] for m in card16]}")
    t0 = time.perf_counter()
    cpu = cpu_job.get(timeout=900)
    waited = time.perf_counter() - t0
    try:
        err, sum_lr, named = compare_train(
            np, "15c", card32, card, card_grads, names,
            load_cpu_arrays(np, cpu))
    finally:
        shutil.rmtree(cpu["dir"], ignore_errors=True)
    cfg, batch, seq = train_cut("hybrid")
    timed = sorted(times[1:])
    med = (timed[(len(timed) - 1) // 2] + timed[len(timed) // 2]) / 2
    say(f"phase 15c training {cfg.name} cut ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.moe.n_experts} experts top "
        f"{cfg.moe.top_k} of d_ff {cfg.moe.d_ff}, d_state "
        f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}; {batch} x {seq} "
        f"tokens): {len(card32)} float32 steps on the card == the CPU's "
        f"(losses " + ", ".join(f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b
                                in zip(card32, cpu["float32"]))
        + f"; master max err {err['master']:.3g} of sum(lr), a share "
        f"{err['master_tail']:.3g} beyond {TRAIN_MASTER_LR_TOL} "
        f"({len(named)} elements); m {err['m']:.3g}, v {err['v']:.3g} of "
        f"each leaf's largest); bf16 step {med:.1f} ms median of the last "
        f"{len(timed)} ({batch * seq / (med / 1e3):.0f} tokens/s), losses "
        + ", ".join(f"{m['loss']:.4f}" for m in card16)
        + f"; no kernel launched; the CPU process took {cpu['s']:.1f} s "
        f"(waited {waited:.1f} s for it)")
    return {"float32": card32, "bfloat16": card16, "bf16_step_ms": times,
            "bf16_step_ms_median": med, "cpu": {
                k: cpu[k] for k in ("float32", "s")}, "cpu_wait_s": waited,
            "max_err": err, "sum_lr": sum_lr, "master_tail": named,
            "launches": counts}


def phase_hybrid(torch, np, ops, ref, dev, lm, moe_mod, cpu_job):
    """Phase 15: (a) HYBRID_ARCH at HYBRID_LAYERS layers served, forked
    and profiled, (b) selective_scan against its plain version and timed,
    (c) the training cut against the CPU. Returns the kernel line's
    selective_scan entry and the detail (with (a)'s flash and rowclone
    launches)."""
    configs, _, engine_mod = lm
    t_phase = time.perf_counter()
    out = {}
    cfg = configs.get_config(HYBRID_ARCH).scaled(n_layers=HYBRID_LAYERS)
    flash_n, out["serve"], model, params, prompts, rec = phase_serve(
        torch, np, ops, ref, dev, lm, moe_mod, cfg, "phase 15a")
    rc_n, out["fork"], cache1, fork = phase_fork(
        torch, ops, dev, lm, model, params, prompts, label="phase 15a")
    fork_engine = engine_mod.ServeEngine(model, params, model.s_max)
    out["profile"] = phase_profile(
        torch, model, params, prompts, fork,
        lambda: fork_engine.fork_cache(cache1, FORK_N), label="phase 15a")
    entry = phase_ssm_kernel(torch, ops, ref, dev, rec.scan_args,
                             out["serve"]["launches"]["selective_scan"])
    del model, params, rec, cache1, fork, fork_engine
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = phase_hybrid_train(torch, np, ops, dev, cpu_job)
    out.update(flash_launches=flash_n, rowclone_launches=rc_n,
               seconds=time.perf_counter() - t_phase)
    say(f"phase 15 mamba hybrid: {out['seconds']:.1f} s; selective_scan "
        f"launches {entry['launches']}, flash_attention launches {flash_n}, "
        f"rowclone_copy launches {rc_n}")
    return entry, out


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
                                      policysearch, smcprog, techniques,
                                      timescale, traces)
        from repro_torch import configs, service
        from repro_torch.kernels import ops, ref
        from repro_torch.models import model_zoo, moe as moe_mod
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
    # phase 7d's plain-engine search runs beside every phase before it
    first, _ = traces.polybench_trace(traces.POLYBENCH[0], geo)
    search_pool = multiprocessing.get_context("spawn").Pool(1)
    hybrid_pool = multiprocessing.get_context("spawn").Pool(1)
    cpu_search = search_pool.apply_async(search_job, ({
        f: getattr(first, f)[:SEARCH_CUT]
        for f in ("kind", "bank", "row", "delta", "dep")}, SEARCH_SEED))
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
        counts, report["main"], slower_buckets, main_inputs = phase_main(
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
        grid, grid_serial, report["executor"] = phase_executor(
            np, torch, ops, emu, campaign, techniques, policysearch, smcprog,
            traces, timescale, main_inputs, report["stream"], cpu_search)
        report["service"] = phase_service(np, torch, ops, emu, service,
                                          grid, grid_serial)
        ref_entry, report["ref_engine"] = phase_ref(
            np, torch, ops, ref, emu, smcprog, timescale, traces, faults,
            bloom_mod, main_inputs, grid, grid_serial)
        kernels.append(ref_entry)

        lm = (configs, model_zoo, engine_mod)
        report["flash_grid_err"] = phase_lm_kernels(torch, ops, ref, dev)
        flash_n, report["serve"], model, params, prompts, lm_rec = \
            phase_serve(torch, np, ops, ref, dev, lm, moe_mod,
                        configs.get_config(LM_ARCH), "phase 9")
        rc_n, report["fork"], cache1, fork = phase_fork(
            torch, ops, dev, lm, model, params, prompts)
        fork_engine = engine_mod.ServeEngine(model, params, model.s_max)
        report["profile"] = phase_profile(
            torch, model, params, prompts, fork,
            lambda: fork_engine.fork_cache(cache1, FORK_N))
        kernels += phase_lm_timing(torch, ops, ref, lm_rec, cache1, flash_n,
                                   rc_n)
        # the serving model's 33 GB leave the card before training
        del model, params, prompts, lm_rec, cache1, fork, fork_engine
        gc.collect()
        torch.cuda.empty_cache()
        report["train"] = phase_train(torch, np, ops, dev)
        gc.collect()
        torch.cuda.empty_cache()
        # phase 15c's CPU side runs beside phases 14 and 15a-b
        hybrid_cpu = hybrid_pool.apply_async(train_cpu_job, ("hybrid",))
        report["moe"] = phase_moe(torch, np, ops, ref, dev, lm, moe_mod)
        gc.collect()
        torch.cuda.empty_cache()
        entry, report["hybrid"] = phase_hybrid(torch, np, ops, ref, dev, lm,
                                               moe_mod, hybrid_cpu)
        for k in kernels:
            k["launches"] += sum(
                {"flash_attention": r["flash_launches"],
                 "rowclone_copy": r["rowclone_launches"]}.get(k["name"], 0)
                for r in (report["moe"], report["hybrid"]))
        kernels.append(entry)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        rec.restore()
        for pool in (search_pool, hybrid_pool):
            pool.terminate()
            pool.join()
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
