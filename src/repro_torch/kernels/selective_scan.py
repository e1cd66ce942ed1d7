"""CUDA wrapper of the selective-scan kernel (``csrc/selective_scan.cu``).

Replaces the reference's chunked selective scan in
``repro.models.mamba`` (``_chunk_scan``, an ``associative_scan``, inside
``mamba_seq``'s remat'd ``lax.scan`` over chunks; not a Pallas kernel);
the plain version is ``repro_torch.kernels.ref.selective_scan_ref``.
"""
from __future__ import annotations

import torch

N_STATES = (8, 16)


def selective_scan_cuda(u, dt, Bm, Cm, A, D, h0):
    """u, dt ``[B, S, di]``, Bm / Cm ``[B, S, N]``, A ``[di, N]``, D
    ``[di]``, h0 ``[B, di, N]``, all contiguous float32 on one CUDA
    device -> (y ``[B, S, di]``, hT ``[B, di, N]``). Launches on the
    current stream; an empty sequence launches nothing (y empty, hT a
    copy of h0)."""
    from repro_torch.kernels import ops
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"selective_scan_cuda needs u, dt [B, S, di], got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}")
    B, S, di = u.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    want = {"Bm": (B, S, N), "Cm": (B, S, N), "A": (di, N), "D": (di,),
            "h0": (B, di, N)}
    got = {"Bm": Bm, "Cm": Cm, "A": A, "D": D, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"selective_scan_cuda: {name} is "
                             f"{tuple(got[name].shape)}, not {shape}")
    if N not in N_STATES:
        raise ValueError(f"selective_scan_cuda takes d_state in {N_STATES}, "
                         f"got {N}")
    tensors = (u, dt, Bm, Cm, A, D, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("selective_scan_cuda takes float32 tensors, got "
                         f"{[str(t.dtype) for t in tensors]}")
    dev = u.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"selective_scan_cuda needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan_cuda needs contiguous tensors")
    y = torch.empty_like(u)
    if S == 0 or B == 0 or di == 0:   # nothing to scan: no launch
        return y, h0.clone()
    hT = torch.empty_like(h0)
    err = ops.library().selective_scan_launch(
        *(ops.ptr(t) for t in tensors), ops.ptr(y), ops.ptr(hT), int(B),
        int(S), int(di), int(N), ops.stream_handle(dev))
    ops.check_launch("selective_scan", err)
    return y, hT
