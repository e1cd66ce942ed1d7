"""CUDA wrapper of the batch policy-VM kernel (``csrc/policy_vm.cu``).

Replaces the TPU kernel ``repro.kernels.policy_vm``; the plain version is
``repro_torch.kernels.ref.policy_vm_ref``. The VM
(``csrc/policy_vm.cuh``: each table decoded once per launch, then run
per lane) is the one the slot-scan kernel runs on every scheduling
decision. A table of up to :data:`FAST_TABLE` rows runs in the kernel's
fast instantiation (two lanes a thread, the values in shared memory); a
longer one, which the reference's ``table_bucket`` allows, in its wide
instantiation (one lane a thread, the values in shared memory or in
global scratch).
"""
from __future__ import annotations

import torch

from repro_torch.core.smcprog import N_LOADS

FAST_TABLE = 256   # REPRO_VM_MAX_L in policy_vm.cuh


def policy_vm_cuda(tables: torch.Tensor, envm: torch.Tensor) -> torch.Tensor:
    """``tables`` int32 ``[P, L + 1, 4]``, ``envm`` int32 ``[N_LOADS, Q]``
    -> int32 ``[P, 3, Q]`` (score, boost, mitigate)."""
    from repro_torch.kernels import ops
    dev = tables.device
    if dev.type != "cuda" or envm.device != dev:
        raise ValueError(
            f"policy_vm_cuda needs CUDA tensors on one device, got tables "
            f"on {dev} and env on {envm.device}")
    if tables.dtype != torch.int32 or envm.dtype != torch.int32 \
            or tables.dim() != 3 or tables.shape[2] != 4 \
            or envm.dim() != 2 or envm.shape[0] != N_LOADS \
            or not tables.is_contiguous() or not envm.is_contiguous():
        raise ValueError("policy_vm_cuda needs contiguous int32 tables "
                         "[P, L + 1, 4] and env [N_LOADS, Q]")
    L = int(tables.shape[1]) - 1
    if L < 1:
        raise ValueError(f"table length {L} below 1")
    P, Q = int(tables.shape[0]), int(envm.shape[1])
    out = torch.empty((P, 3, Q), dtype=torch.int32, device=dev)
    if out.numel() == 0:   # no program or no lane: no launch, nothing counted
        return out
    lib = ops.library()
    tables = ops.aligned16(tables)   # the kernel loads rows as int4
    if L <= FAST_TABLE:
        err = lib.policy_vm_launch(ops.ptr(tables), P, L, ops.ptr(envm), Q,
                                   ops.ptr(out), ops.stream_handle(dev))
        ops.check_launch("policy_vm", err, "fast")
        return out
    n_scratch = lib.policy_vm_wide_scratch_ints(P, L)
    if n_scratch < 0:
        raise ValueError(f"policy_vm: a {L}-row table cannot be indexed "
                         f"with 32-bit offsets")
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev) \
        if n_scratch else None
    err = lib.policy_vm_wide_launch(ops.ptr(tables), P, L, ops.ptr(envm), Q,
                                    ops.ptr(out), ops.ptr(scratch),
                                    ops.stream_handle(dev))
    ops.check_launch("policy_vm", err,
                     "wide-global" if n_scratch else "wide-shared")
    return out
