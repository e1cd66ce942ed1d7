"""Each CUDA kernel of the port against its plain PyTorch version on the
card, exactly. Marked ``cuda``: they skip without a CUDA device. This
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
from repro_torch.kernels.slot_scan import ScanParams

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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["legacy", "table-and-weak"])
def test_slot_scan_kernel_matches_plain(cuda_device, variant):
    rng = np.random.RandomState(0)
    B, n = 4, 64
    arrs = [rng.randint(0, 5, (B, n)), rng.randint(0, 16, (B, n)),
            rng.randint(0, 64, (B, n)), rng.randint(0, 24, (B, n)),
            rng.randint(0, 3, (B, n))]
    args = [torch.from_numpy(a.astype(np.int32)).to(cuda_device)
            for a in arrs]
    costs = torch.tensor([[520, 260]] * B, dtype=torch.int32,
                         device=cuda_device)
    p = scan_params(B, n)
    weak = tables = None
    if variant != "legacy":
        weak = torch.from_numpy(rng.randint(0, 2, (B, n)).astype(
            np.int8)).to(cuda_device)
        progs = list(smcprog.builtin_programs().values())[:B]
        tables = torch.from_numpy(smcprog.pack_stack(progs, 8)).to(
            cuda_device)
        p = dataclasses.replace(p, nots=1, table_len=8, use_weak=1)
    got = ops.slot_scan(*args, weak, tables, costs, p)
    want = ref.slot_scan_ref(*args, weak, tables, costs, p)
    for f in want:
        assert torch.equal(got[f], want[f]), f


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
    else:
        e = torch.empty((0, 64), dtype=torch.int32, device=cuda_device)
        costs = torch.empty((0, 2), dtype=torch.int32, device=cuda_device)
        out = ops.slot_scan(e, e, e, e, e, None, None, costs,
                            scan_params(0, 64))["t_resp"]
    assert out.numel() == 0
    assert ops.launches()[name] == 0
