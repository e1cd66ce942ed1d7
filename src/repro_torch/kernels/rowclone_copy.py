"""CUDA wrapper of the bulk-copy kernel (``csrc/rowclone_copy.cu``).

Replaces the TPU kernel ``repro.kernels.rowclone_copy``; the plain
version is ``repro_torch.kernels.ref.rowclone_copy_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch


def rowclone_copy_cuda(x: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy a contiguous ``[R, C]`` tensor of any dtype, byte for byte,
    into a new tensor or into ``out``: ``[R, C]`` of x's dtype whose rows
    are contiguous and may lie any stride apart (a slot of a larger
    tensor). Launches on the current stream."""
    from repro_torch.kernels import ops
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"rowclone_copy_cuda needs a contiguous [R, C] "
                         f"tensor, got shape {tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or (x.shape[1] > 1 and out.stride(1) != 1)
                            or (x.shape[0] > 1
                                and out.stride(0) < x.shape[1])):
        raise ValueError(f"out must be {tuple(x.shape)} {x.dtype} with "
                         f"contiguous rows, got {tuple(out.shape)} "
                         f"{out.dtype} strides {out.stride()}")
    dev = x.device
    if dev.type != "cuda" or (out is not None and out.device != dev):
        raise ValueError(f"rowclone_copy_cuda needs CUDA tensors on one "
                         f"device, got x on {dev}"
                         + ("" if out is None else f", out on {out.device}"))
    if out is None:
        out = torch.empty_like(x)
    if x.numel() == 0:   # nothing to copy: no launch, nothing counted
        return out
    size = x.element_size()
    err = ops.library().rowclone_copy_launch(
        ops.ptr(x), ops.ptr(out), int(x.shape[0]), int(x.shape[1]) * size,
        int(out.stride(0)) * size, ops.stream_handle(dev))
    ops.check_launch("rowclone_copy", err)
    return out
