"""CUDA wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro.kernels.flash_attention``
(``flash_attention_bhsd``); the plain version is
``repro_torch.kernels.ref.flash_attention_ref``. Takes the flattened head
layout: q ``[B * KV * G, Sq, hd]``, k / v ``[B * KV, Sk, hd]``.
"""
from __future__ import annotations

import torch

HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Attention of each q row over its kv row (``i // G``), online
    softmax in float32, output in q's dtype. Launches on the current
    stream. Causal attention needs ``Sq == Sk``: the kernel's mask is the
    reference kernel's ``q_pos >= k_pos``, with no ``Sk - Sq`` offset."""
    from repro_torch.kernels import ops
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda needs q [BHq, Sq, hd] and "
                         f"k, v [BHkv, Sk, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, hd = q.shape
    BK, Sk, _ = k.shape
    if k.shape[2] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS} "
                         f"(q {hd}, k {k.shape[2]})")
    if BK == 0 or BH % BK:
        raise ValueError(f"{BH} q heads do not group over {BK} kv heads")
    if causal and Sq != Sk:
        raise ValueError(f"causal flash_attention_cuda needs Sq == Sk, got "
                         f"{Sq} and {Sk}")
    if Sk == 0 and Sq > 0:
        raise ValueError("flash_attention_cuda needs at least one key")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention_cuda needs contiguous, 16-byte "
                             "aligned q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:   # nothing to attend: no launch, nothing counted
        return out
    err = ops.library().flash_attention_launch(
        ops.ptr(q), ops.ptr(k), ops.ptr(v), ops.ptr(out), int(BH),
        int(BH // BK), int(Sq), int(Sk), int(hd), _DTYPES[q.dtype],
        int(bool(causal)), float(hd ** -0.5), ops.stream_handle(dev))
    ops.check_launch("flash_attention", err)
    return out
