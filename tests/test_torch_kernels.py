"""The port's kernel modules on the CPU: each plain version against the
JAX reference (the Pallas kernels in interpret mode and their jnp
oracles) on the same seeded inputs, exactly, and the CUDA wrappers'
input guards. The kernels themselves are held against their plain
versions in test_torch_cuda.py (on a card) and by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import smcprog as jsmc
from repro.core.bloom import BloomFilter
from repro.core.policysearch import random_program
from repro.kernels import ref as jref
from repro.kernels.policy_vm import policy_vm_scores

from repro_torch.core import smcprog as psmc
from repro_torch.core.bloom import words_tensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bloom_probe import bloom_probe_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.policy_vm import policy_vm_cuda
from repro_torch.kernels.rowclone_copy import rowclone_copy_cuda
from repro_torch.kernels.slot_scan import ScanParams, slot_scan_cuda

torch.set_num_threads(1)

BLOOM_GRID = [(1 << 14, 2, 100), (1 << 16, 4, 5000), (1 << 18, 6, 20000)]


def bloom_case(m_bits, k, n):
    keys_in = np.arange(0, n * 3, 3, dtype=np.uint32)
    bf = BloomFilter.build(keys_in, m_bits=m_bits, k=k)
    probes = np.arange(0, n * 4, dtype=np.uint32)
    return bf, keys_in, probes


@pytest.mark.parametrize("m_bits,k,n", BLOOM_GRID)
def test_bloom_probe_plain_matches_jax(m_bits, k, n):
    bf, keys_in, probes = bloom_case(m_bits, k, n)
    want = np.asarray(jref.bloom_probe_ref(bf.bits, jnp.asarray(probes), k,
                                           m_bits))
    words = words_tensor(bf.bits).unsqueeze(0)
    keys = torch.from_numpy(probes.view(np.int32)).unsqueeze(0)
    got = ops.bloom_probe(words, keys, k, m_bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), want)
    ins = torch.from_numpy(keys_in.view(np.int32)).unsqueeze(0)
    assert bool(ops.bloom_probe(words, ins, k, m_bits).all())


def test_bloom_probe_per_row_words():
    """[B, W] words: each row probes against its own filter, exactly as
    one probe per row does; keys above 2^31 keep their uint32 bits."""
    rng = np.random.RandomState(0)
    filters = [BloomFilter.build(rng.randint(0, 1 << 30, 400).astype(
        np.uint32), 1 << 14, 3) for _ in range(3)]
    probes = rng.randint(0, 1 << 32, (3, 700), dtype=np.uint64).astype(
        np.uint32)
    words = words_tensor(np.stack([f.bits for f in filters]))
    got = ops.bloom_probe(words, torch.from_numpy(probes.view(np.int32)), 3,
                          1 << 14)
    for i, f in enumerate(filters):
        want = np.asarray(jref.bloom_probe_ref(f.bits, jnp.asarray(probes[i]),
                                               3, 1 << 14))
        np.testing.assert_array_equal(got[i].numpy(), want)


def vm_inputs(bucket, seed=0, q=16):
    rng = np.random.RandomState(seed)
    progs = [p for p in list(jsmc.builtin_programs().values())
             + list(jsmc.mitigation_programs().values())
             if jsmc.table_bucket(p.n_ops) <= bucket]
    progs += [random_program(rng, max_ops=bucket, name=f"r{i}")
              for i in range(24)]
    tables = jsmc.pack_stack(progs, bucket)
    env = rng.randint(-2 ** 31, 2 ** 31, (jsmc.N_LOADS, q)).astype(np.int64)
    env[:, : q // 2] = rng.randint(-40, 64, (jsmc.N_LOADS, q // 2))
    env[0, q // 4:q // 2] = rng.randint(2 ** 30, 2 ** 31, q // 4)
    return tables, env.astype(np.int32)


@pytest.mark.parametrize("bucket", [8, 16])
def test_policy_vm_plain_matches_jax_kernel_and_oracle(bucket):
    tables, env = vm_inputs(bucket)
    want_k = np.asarray(policy_vm_scores(tables, env, interpret=True))
    want_r = np.asarray(jref.policy_vm_ref(tables, env))
    got = ops.policy_vm(torch.from_numpy(tables), torch.from_numpy(env))
    np.testing.assert_array_equal(got.numpy(), want_k)
    np.testing.assert_array_equal(got.numpy(), want_r)


def test_policy_vm_garbage_tables_match_jax():
    """Out-of-range operands, unknown opcodes and forward references
    follow the reference VM's clipping and zero-init exactly."""
    rng = np.random.RandomState(3)
    tables = rng.randint(-3, 30, (12, 9, 4)).astype(np.int32)
    env = rng.randint(-2 ** 31, 2 ** 31, (jsmc.N_LOADS, 8)).astype(np.int32)
    want = np.asarray(jref.policy_vm_ref(tables, env))
    got = ops.policy_vm(torch.from_numpy(tables), torch.from_numpy(env))
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_slot_table_matches_jax():
    rng = np.random.RandomState(4)
    for _ in range(50):
        q = 6
        score = rng.randint(-5, 5, q).astype(np.int32)
        boost = rng.randint(0, 2, q).astype(np.int32)
        vis = rng.rand(q) < 0.6
        # the program's score is the 'age' load, its boost 'age_rel'
        env = {nm: (lambda v=v: jnp.asarray(v)) for nm, v in zip(
            jsmc._ENV_ORDER, [score] + [boost] + [score] * 10)}
        table = jsmc.pack_program(jsmc.PolicyProgram(
            ((jsmc.OP_AGE, 0, 0, 0), (jsmc.OP_AGE_REL, 0, 0, 0)),
            score_reg=0, boost_reg=1))
        want, _ = jsmc.select_slot_table(table, env, jnp.asarray(vis))
        got = psmc.select_slot_table(torch.from_numpy(score)[None],
                                     torch.from_numpy(boost)[None],
                                     torch.from_numpy(vis)[None])
        assert int(want) == int(got[0])


def test_cpu_routing_counts_no_launches():
    ops.reset_launches()
    tables, env = vm_inputs(8)
    ops.policy_vm(torch.from_numpy(tables), torch.from_numpy(env))
    bf, _, probes = bloom_case(1 << 14, 2, 100)
    ops.bloom_probe(words_tensor(bf.bits)[None],
                    torch.from_numpy(probes.view(np.int32))[None], 2, 1 << 14)
    q = torch.randn(1, 128, 4, 64)
    kv = torch.randn(1, 128, 2, 64)
    ops.flash_attention(q, kv, kv, causal=True)
    ops.flash_attention_bhsd(q[0].transpose(0, 1).contiguous(),
                             kv[0].transpose(0, 1).contiguous(),
                             kv[0].transpose(0, 1).contiguous(), False)
    ops.rowclone_copy(torch.zeros((4, 8), dtype=torch.int8))
    assert ops.launches() == {name: 0 for name in ops.KERNELS}


def scan_params(batch=1, n=32):
    return ScanParams(batch=batch, n=n, window=4, q=4, slots=80, n_banks=16,
                      n_rows=32768, scale_num=4879, mc_lat=29, mc_issue_ts=3,
                      nots=0, frfcfs=1, table_len=0, use_weak=0, tRCD=17,
                      tRCD_reduced=11, tCL=17, tRP=17, tRAS=39, tWR=18, tBL=4,
                      tRFC=420, tREFI=9360, tRC_CLONE=90)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: CPU tensors raise before any
    build or launch."""
    z = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bloom_probe_cuda(torch.zeros((1, 512), dtype=torch.int32), z, 2,
                         1 << 14)
    with pytest.raises(ValueError, match="CUDA"):
        policy_vm_cuda(torch.zeros((2, 9, 4), dtype=torch.int32),
                       torch.zeros((psmc.N_LOADS, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        slot_scan_cuda(z, z, z, z, z, None, None,
                       torch.zeros((1, 2), dtype=torch.int32), scan_params())
    q = torch.zeros((8, 128, 64))
    kv = torch.zeros((2, 128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        rowclone_copy_cuda(torch.zeros((4, 8)))


def test_flash_attention_hands_the_kernel_contiguous_heads(monkeypatch):
    """The GQA flattening of a batch-1 q is a strided view until copied:
    the kernel takes contiguous rows only."""
    seen = []

    def bhsd(q, k, v, causal=True):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return ref.flash_attention_ref(q, k, v, causal)

    monkeypatch.setattr(ops, "flash_attention_bhsd", bhsd)
    for H, KV in ((4, 4), (4, 1)):
        ops.flash_attention(torch.randn(1, 128, H, 64),
                            torch.randn(1, 128, KV, 64),
                            torch.randn(1, 128, KV, 64))
    assert seen == [True, True]


@pytest.mark.parametrize("hd", [16, 32, 96, 512])
def test_flash_attention_cuda_refuses_unsupported_head_dims(hd):
    """The kernel takes hd 64, 128, 256; the plain version takes any."""
    q = torch.zeros((4, 128, hd))
    kv = torch.zeros((2, 128, hd))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q, kv, kv, causal=False)
    assert ops.flash_attention_bhsd(q, kv, kv, False).shape == q.shape


def test_flash_attention_cuda_refuses_causal_ragged_and_bad_groups():
    """Causal needs Sq == Sk: the kernel's mask has no Sk - Sq offset."""
    q = torch.zeros((4, 128, 64))
    kv = torch.zeros((2, 256, 64))
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_cuda(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="group"):
        flash_attention_cuda(torch.zeros((3, 128, 64)), kv, kv, causal=False)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q.half(), kv.half(), kv.half(), causal=False)


def test_rowclone_copy_cuda_refuses_bad_out():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        rowclone_copy_cuda(torch.zeros((8, 4)).t())
    with pytest.raises(ValueError, match="out must be"):
        rowclone_copy_cuda(x, out=torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        rowclone_copy_cuda(x, out=torch.zeros((8, 4)).t())


def test_routing_rejects_other_devices():
    t = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.bloom_probe(t, t, 2, 128)


# ---- the flash kernel's numeric decision: 3xTF32 products ----

FLASH_GRID = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 8, 8, 128),
              (1, 128, 4, 1, 256)]     # tests/test_kernels.py


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` with the 13 low bits cleared, on the float32
    bits: round to nearest, ties away from zero (sign and magnitude)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a, b, passes):
    """``a @ b`` as the kernel's mma.sync sees it: one TF32 product, or
    three (lo.hi + hi.lo + hi.hi, x_lo = tf32(x - x_hi)), fp32 sums."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def flash_tf32(q, k, v, causal, passes):
    """Attention with both products in TF32 (the kernel's arithmetic, up to
    summation order): q scaled in fp32 before its split, fp32 softmax."""
    BH, S, hd = q.shape
    G = BH // k.shape[0]
    kf = k.float().repeat_interleave(G, dim=0)
    vf = v.float().repeat_interleave(G, dim=0)
    s = tf32_matmul(q.float() * hd ** -0.5, kf.transpose(1, 2), passes)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool).tril()
        s = torch.where(mask, s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return tf32_matmul(p, vf, passes) / p.sum(-1, keepdim=True)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10            # TF32 keeps 10 fraction bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 2.0 ** -130])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         2.0 ** -130])
    assert torch.equal(tf32_rna(x), want)
    # a bf16 value is exact in TF32: bf16 K and V take two products
    kv = torch.from_numpy(np.random.RandomState(0).randn(4096)).to(
        torch.bfloat16).float()
    assert torch.equal(tf32_rna(kv), kv)


@pytest.fixture
def ieee_fp32_matmul():
    """Pin the process-wide float32 matmul precision to IEEE for the TF32
    arithmetic below, and restore it after. Under
    ``torch.set_float32_matmul_precision("medium")``, or oneDNN's
    ``torch.backends.mkldnn.matmul.fp32_precision = "bf16"``, the CPU's
    float32 ``@`` runs in bf16 on a host with AMX-BF16, and the 3xTF32
    products miss the 2e-5 tolerance on every case of the grid: any code
    that ran earlier in the same process may have left either set."""
    mkl = torch.backends.mkldnn.matmul
    old, old_mkl = torch.get_float32_matmul_precision(), mkl.fp32_precision
    torch.set_float32_matmul_precision("highest")
    mkl.fp32_precision = "ieee"
    yield
    torch.set_float32_matmul_precision(old)
    mkl.fp32_precision = old_mkl


@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_3xtf32_meets_the_fp32_tolerance_and_1xtf32_does_not(
        B, S, H, KV, hd, causal, ieee_fp32_matmul):
    """Why the kernel splits every product in three: on the reference grid
    the 3xTF32 products stay within the fp32 tolerance (2e-5) of the
    plain version, a single TF32 pass does not."""
    rng = np.random.RandomState(B * S + H)
    q = torch.from_numpy(rng.randn(B * H, S, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B * KV, S, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(B * KV, S, hd).astype(np.float32))
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(flash_tf32(q, k, v, causal, 3), want,
                               atol=2e-5, rtol=2e-5)
    one = flash_tf32(q, k, v, causal, 1)
    assert not torch.allclose(one, want, atol=2e-5, rtol=2e-5)
    assert float((one - want).abs().max()) > 1e-4
