"""CUDA wrapper of the Bloom-filter probe kernel (``csrc/bloom_probe.cu``).

Replaces the TPU kernel ``repro.kernels.bloom_probe``; the plain version
is ``repro_torch.kernels.ref.bloom_probe_ref``.
"""
from __future__ import annotations

import torch


def bloom_probe_cuda(words: torch.Tensor, keys: torch.Tensor, k: int,
                     m_bits: int) -> torch.Tensor:
    """``words`` int32 ``[Bw, W]`` (uint32 bit patterns, ``Bw`` 1 or B),
    ``keys`` int32 ``[B, N]`` (uint32 bit patterns) -> int8 ``[B, N]``,
    1 = possibly in the set. Launches on the current stream."""
    from repro_torch.kernels import ops
    dev = keys.device
    if dev.type != "cuda" or words.device != dev:
        raise ValueError(
            f"bloom_probe_cuda needs CUDA tensors on one device, got words "
            f"on {words.device} and keys on {dev}")
    if words.dtype != torch.int32 or keys.dtype != torch.int32 \
            or words.dim() != 2 or keys.dim() != 2 \
            or not words.is_contiguous() or not keys.is_contiguous():
        raise ValueError("bloom_probe_cuda needs contiguous 2-D int32 words "
                         "and keys")
    if m_bits < 32 or m_bits & (m_bits - 1) or words.shape[1] != m_bits // 32:
        raise ValueError(f"m_bits {m_bits} does not match {words.shape[1]} "
                         f"words")
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in 1..8, got {k}")
    if words.shape[0] not in (1, keys.shape[0]):
        raise ValueError(f"words batch {words.shape[0]} must be 1 or the "
                         f"keys batch {keys.shape[0]}")
    out = torch.empty(keys.shape, dtype=torch.int8, device=dev)
    if out.numel() == 0:   # nothing to probe: no launch, nothing counted
        return out
    err = ops.library().bloom_probe_launch(
        ops.ptr(words), int(words.shape[0]), int(words.shape[1]),
        ops.ptr(keys), ops.ptr(out), int(keys.shape[0]), int(keys.shape[1]),
        int(k), int(m_bits), ops.stream_handle(dev))
    ops.check_launch("bloom_probe", err)
    return out
