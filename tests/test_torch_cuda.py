"""Each CUDA kernel of the port against its plain PyTorch version on the
card: exactly for the integer kernels and the copy, within the stated
tolerance for flash attention. Marked ``cuda``: they skip without a CUDA device. This
file imports no JAX, so it also runs on a GPU machine that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import smcprog
from repro_torch.core.bloom import BloomFilter, words_tensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rowclone_copy import rowclone_copy_cuda
from repro_torch.kernels.slot_scan import (MAX_BANKS, MAX_Q, MAX_TABLE,
                                           RESP_RING, ScanParams,
                                           slot_scan_cuda)

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
@pytest.mark.parametrize("bucket", [8, 16])
def test_policy_vm_kernel_matches_plain(cuda_device, bucket):
    tables, env = vm_inputs(bucket)
    t = torch.from_numpy(tables).to(cuda_device)
    e = torch.from_numpy(env).to(cuda_device)
    assert torch.equal(ops.policy_vm(t, e), ref.policy_vm_ref(t, e))


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
    "ring-and-far-deps": {"B": 2, "n": RESP_RING + 512, "far_deps": True,
                          "slots": 2 * (RESP_RING + 512) + 8},
    "nop-filler-row": {"nop_rows": (1,)},
    "drain-early": {"real": 8, "slots": 1000},
    "budget-ends-mid-trace": {"slots": 40},
    "odd-divisors": {"params": {"tREFI": 97, "scale_num": 3001,
                                "tRFC": 41}},
    "table256": {"B": 2, "n": 32, "slots": 80, "table": 256, "nots": 1},
}


def scan_case(dev, B=4, n=64, window=4, banks=16, slots=200, table=0,
              weak=False, nots=0, far_deps=False, nop_rows=(), real=None,
              params=None):
    """Seeded inputs of one slot-scan group; the queue has
    ``max(window, 2)`` lanes, as the engine sizes it."""
    rng = np.random.RandomState(0)
    kind, bank, row, delta, dep = (
        rng.randint(0, 5, (B, n)), rng.randint(0, banks, (B, n)),
        rng.randint(0, 64, (B, n)), rng.randint(0, 24, (B, n)),
        rng.randint(0, 3, (B, n)))
    if far_deps:   # some requests wait on one issued more than a ring ago
        far = rng.random_sample((B, n)) < 0.1
        dep[far] = rng.randint(RESP_RING + 1, RESP_RING + 256, int(far.sum()))
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
    if table:
        progs = list(smcprog.builtin_programs().values())
        progs = [progs[i % len(progs)] for i in range(B)]
        tables = torch.from_numpy(smcprog.pack_stack(progs, table)).to(dev)
        p = dataclasses.replace(p, table_len=table)
    return args, w, tables, costs, p


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(SCAN_CASES))
def test_slot_scan_kernel_matches_plain(cuda_device, variant):
    args, weak, tables, costs, p = scan_case(cuda_device, **SCAN_CASES[variant])
    ops.reset_launches()
    got = ops.slot_scan(*args, weak, tables, costs, p)
    torch.cuda.synchronize()
    assert ops.launches()["slot_scan"] == 1
    # the plain version on CPU copies of the same inputs (it is launch-bound
    # on the card)
    cpu = [None if t is None else t.cpu()
           for t in (*args, weak, tables, costs)]
    want = ref.slot_scan_ref(*cpu, p)
    for f in want:
        assert torch.equal(got[f].cpu(), want[f]), f
    if variant == "drain-early":   # the budget outlasts every row
        assert int(want["served"].sum()) == int((args[0] != 4).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [("q", 1), ("q", MAX_Q + 1),
                                         ("n_banks", 0),
                                         ("n_banks", MAX_BANKS + 1),
                                         ("table_len", MAX_TABLE + 1),
                                         ("tREFI", 0), ("window", 5)])
def test_slot_scan_cuda_refuses_past_its_limits(cuda_device, field, value):
    args, weak, tables, costs, p = scan_case(cuda_device)
    with pytest.raises(ValueError, match="slot_scan kernel limits"):
        slot_scan_cuda(*args, weak, tables, costs,
                       dataclasses.replace(p, **{field: value}))


# the grid and tolerances of tests/test_kernels.py: the kernel sums in
# another order than the plain softmax (online, 64-key tiles)
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
    else:
        e = torch.empty((0, 64), dtype=torch.int32, device=cuda_device)
        costs = torch.empty((0, 2), dtype=torch.int32, device=cuda_device)
        out = ops.slot_scan(e, e, e, e, e, None, None, costs,
                            scan_params(0, 64))["t_resp"]
    assert out.numel() == 0
    assert ops.launches()[name] == 0
