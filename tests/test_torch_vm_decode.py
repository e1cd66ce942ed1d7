"""The decoded form of a policy table, which the CUDA kernels build once per
launch and run on every evaluation (``csrc/policy_vm.cuh``), held against
the JAX VM: ``ref.decode_table`` plus ``ref.eval_decoded`` must equal
``repro.core.smcprog.eval_table_rows`` (through the oracle
``repro.kernels.ref.policy_vm_ref``) and the Pallas kernel
``policy_vm_scores`` in interpret mode, exactly, over seeded tables of
every bucket from 8 to 1024 and over the built-in programs.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import smcprog as jsmc
from repro.core.policysearch import random_program
from repro.kernels import ref as jref
from repro.kernels.policy_vm import policy_vm_scores

from repro_torch.kernels import ref

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (garbage tables, shared with the card)

BUCKETS = [8, 16, 32, 64, 128, 256, 512, 1024]


def env_matrix(rng, q=12):
    """Environment values: small ones (operands equal, zero, negative),
    ages near the int32 edge (age + age and age * const wrap) and the
    full int32 range."""
    env = rng.randint(-2 ** 31, 2 ** 31, (jsmc.N_LOADS, q)).astype(np.int64)
    env[:, : q // 3] = rng.randint(-3, 4, (jsmc.N_LOADS, q // 3))
    env[0, q // 3: 2 * q // 3] = rng.randint(2 ** 30, 2 ** 31, q // 3)
    return env.astype(np.int32)


def seeded_tables(bucket, seed):
    rng = np.random.RandomState(seed)
    progs = [random_program(rng, max_ops=bucket, name=f"r{i}")
             for i in range(6)]
    tables = np.concatenate([chip_smoke.garbage_tables(np, rng, 10, bucket),
                             jsmc.pack_stack(progs, bucket)])
    return tables, env_matrix(rng)


def decoded_scores(tables, env):
    e = torch.from_numpy(env)
    return np.stack([ref.eval_decoded(ref.decode_table(t), e).numpy()
                     for t in tables])


@pytest.mark.parametrize("bucket", BUCKETS)
def test_decoded_tables_match_jax(bucket):
    tables, env = seeded_tables(bucket, seed=bucket)
    got = decoded_scores(tables, env)
    np.testing.assert_array_equal(got, np.asarray(
        jref.policy_vm_ref(tables, env)))
    np.testing.assert_array_equal(got, np.asarray(
        policy_vm_scores(tables, env, interpret=True)))


def all_programs():
    progs = dict(jsmc.builtin_programs())
    progs.update(jsmc.mitigation_programs())
    return progs


@pytest.mark.parametrize("name", sorted(all_programs()))
def test_decoded_builtins_match_jax(name):
    prog = all_programs()[name]
    env = env_matrix(np.random.RandomState(1), q=16)
    for bucket in (jsmc.table_bucket(prog.n_ops), 64):
        table = jsmc.pack_program(prog, bucket)
        dec = ref.decode_table(table)
        got = ref.eval_decoded(dec, torch.from_numpy(env)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jref.policy_vm_ref(table[None], env))[0])
        np.testing.assert_array_equal(got, np.asarray(
            policy_vm_scores(table[None], env, interpret=True))[0])
        # loads and constants run no instruction, padding runs nothing
        n_alu = sum(jsmc.OP_ADD <= op <= jsmc.OP_SELECT
                    for op, *_ in prog.table)
        assert dec.prog.shape[0] <= n_alu


def test_decode_rules():
    """Each rule of the decoded form on a hand-made table: loads become
    slots, NOT becomes EQ with the zero slot, operands at or past their row
    and a negative boost read zero, unreached rows are dropped."""
    C, A, N, S = jsmc.OP_CONST, jsmc.OP_ADD, jsmc.OP_NOT, jsmc.OP_SELECT
    table = np.array([
        (5, 4, -1, -2),                 # header: score row 4, none else
        (jsmc.OP_AGE_REL, 0, 0, 0),     # 0: env slot 1
        (C, 0, 0, 7),                   # 1: constant 7
        (A, 0, 1, 0),                   # 2: age_rel + 7
        (A, 2, 2, 0),                   # 3: dead
        (S, 2, 4, 9),                   # 4: 2 ? zero (self) : row 7 -> zero
        (N, 3, 0, 0),                   # 5: dead padding-like row
        (C, 0, 0, 123),                 # 6: dead constant
        (A, 5, 6, 0),                   # 7: dead
    ], np.int32)
    dec = ref.decode_table(table)
    z, r0 = ref.VM_ZERO, ref.VM_ROW0
    assert dec.prog.tolist() == [
        [A | (r0 + 2) << ref.VM_DST_SHIFT, 1, r0 + 1, z],
        [S | (r0 + 4) << ref.VM_DST_SHIFT, r0 + 2, z, z]]
    assert dec.consts.tolist() == [[r0 + 1, 7]]
    assert (dec.score, dec.boost, dec.mitigate) == (r0 + 4, z, z)
    assert dec.env_mask == 1 << 1
    # a mitigate register past the table clips to row 7, which reaches
    # rows 3, 5 and 6 too
    table[0, 3] = 99
    dec = ref.decode_table(table)
    assert dec.mitigate == r0 + 7
    assert [x >> ref.VM_DST_SHIFT for x in dec.prog[:, 0].tolist()] == [
        r0 + i for i in (2, 3, 4, 5, 7)]
    assert dec.consts.tolist() == [[r0 + 1, 7], [r0 + 6, 123]]
    not_table = np.array([(1, 0, -5, -5), (jsmc.OP_ROW_HIT, 0, 0, 0),
                          (N, 0, 0, 0)], np.int32)
    dec = ref.decode_table(not_table)
    assert dec.prog.tolist() == []
    assert dec.score == 2 and dec.boost == dec.mitigate == z
    not_table[0, 1] = 1
    dec = ref.decode_table(not_table)
    assert dec.prog.tolist() == [
        [jsmc.OP_EQ | (r0 + 1) << ref.VM_DST_SHIFT, 2, z, z]]
