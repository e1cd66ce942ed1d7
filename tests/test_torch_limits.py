"""The port's plain engine against the JAX engine at the shapes that lie
past the warp slot-scan kernel's fast instantiation (a queue above 64
lanes, more than 64 banks, a policy table above 256 rows), exactly on
every field. On the card those shapes run in the wide instantiation of
``csrc/slot_scan.cu``; ``tests/test_torch_cuda.py`` holds it against
this plain engine there."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import emulator as je, smcprog as jsmc
from repro.core.timescale import JETSON_NANO as JN

from repro_torch import interop
from repro_torch.core import emulator as pe

torch.set_num_threads(1)

FIELDS = ("exec_cycles", "row_hits", "served", "dram_ticks",
          "smc_fpga_cycles", "t_resp", "t_issue")


def long_program(n_adds):
    """A fault-free program of ``2 * n_adds + 1`` ops: age plus a chain of
    constant adds (table bucket above 256 for ``n_adds >= 128``), with a
    row-hit boost."""
    b = jsmc.PolicyBuilder()
    v = b.score_age()
    for _ in range(n_adds):
        v = b.add(v, b.const(1))
    return b.build(score=v, boost=b.score_row_hit(), name=f"long{n_adds}")


def trace_arrays(seed, n, n_banks):
    rng = np.random.RandomState(seed)
    return dict(kind=rng.randint(0, 5, n), bank=rng.randint(0, n_banks, n),
                row=rng.randint(0, 64, n), delta=rng.randint(0, 6, n),
                dep=rng.randint(0, 3, n))


# window 80 (an 80-lane queue), 128 banks drawn over all 128, and a
# 259-op program (bucket 512) through run_policies beside a built-in
CASES = {
    "window80": dict(window=80, n=120),
    "banks128": dict(n_banks=128, n=120),
    "table512": dict(n_adds=129, n=40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_engine_matches_jax_past_the_fast_kernel(case):
    c = CASES[case]
    n_banks = c.get("n_banks", 16)
    sysj = dataclasses.replace(
        JN, window=c.get("window", JN.window),
        geometry=dataclasses.replace(JN.geometry, n_banks=n_banks))
    psys = interop.system_config_from_dict(dataclasses.asdict(sysj))
    arrs = trace_arrays(len(case), c["n"], n_banks)
    jt, pt = je.Trace.of(**arrs), interop.trace_from_arrays(**arrs)
    if "n_adds" in c:
        progs = [long_program(c["n_adds"]), jsmc.fcfs_program()]
        assert jsmc.table_bucket(progs[0].n_ops) == 512
        a = je.run_policies(jt, sysj, progs, mode="nots", serial=True)
        b = pe.run_policies(pt, psys, [interop.policy_from_fields(
            **dataclasses.asdict(p)) for p in progs], mode="nots",
            device="cpu")
    else:
        assert sysj.window > 64 or n_banks > 64
        a = [je.run(jt, sysj, m) for m in ("ts", "nots")]
        b = [pe.run(pt, psys, m, device="cpu") for m in ("ts", "nots")]
    for x, y in zip(a, b):
        assert int(x["served"]) == x["n_requests"] > 0
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(x[f]), np.asarray(y[f]),
                                          err_msg=f"{case}: {f}")
