"""Mamba (selective SSM) mixer: causal depthwise conv, selective scan.

Computes what ``repro.models.mamba`` computes, in the same dtypes: the
conv in x's dtype, the scan, its parameters (dt, B, C) and the state
``h`` in float32, the scan's output cast back to x's dtype.

Two routes for the scan over a whole sequence (``mamba_seq``):

* the plain route (``use_kernel=False``, and always under autograd) scans
  the sequence chunk by chunk as the reference does: ``cfg.ssm.chunk``
  tokens, or the largest divisor of S below it, with ``h`` carried
  across chunks. Within a chunk the scan runs token by token (the
  reference's ``associative_scan`` combines the same pairs in a tree),
  and only one chunk's ``[B, T, d_inner, d_state]`` tensors exist at a
  time; in training each chunk is recomputed in the backward pass
  (``L.remat``, the reference's ``jax.checkpoint``).
* the kernel route (``use_kernel=True``, the prefill's, the flag
  ``use_flash`` that picks the flash kernel) hands the whole sequence to
  ``ops.selective_scan``: the CUDA kernel ``csrc/selective_scan.cu`` on a
  CUDA tensor, its plain version on a CPU one. The kernel keeps ``h`` in
  registers and never builds a ``[B, S, d_inner, d_state]`` tensor.

The two scans sum in other orders than the reference's tree; the CPU
tests state the tolerances (``tests/test_torch_mamba.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import remat
from repro_torch.models.pdefs import ParamDef


def mamba_defs(cfg, std=0.02):
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    R = cfg.dt_rank
    N = s.d_state
    return {
        "in_proj": ParamDef((d, 2 * di), ("hidden", "ffn"), std=std),
        "conv_w": ParamDef((s.d_conv, di), (None, "ffn"), std=std),
        "conv_b": ParamDef((di,), ("ffn",), init="zeros"),
        "x_proj": ParamDef((di, R + 2 * N), ("ffn", None), std=std),
        "dt_w": ParamDef((R, di), (None, "ffn"), std=std),
        "dt_b": ParamDef((di,), ("ffn",), init="zeros"),
        "A_log": ParamDef((di, N), ("ffn", "d_state"), init="hippo"),
        "D": ParamDef((di,), ("ffn",), init="ones"),
        "out_proj": ParamDef((di, d), ("ffn", "hidden"), std=std),
    }


def _causal_conv(u, w, b, init_state=None):
    """u ``[B, S, di]``; w ``[K, di]`` depthwise causal; init_state
    ``[B, K-1, di]`` or None (zeros of u's dtype). Returns (y, the last
    K-1 inputs as the new state).

    Summed tap by tap in the reference's order (``F.conv1d`` sums in
    another). The state and u are joined in their promoted dtype, as
    ``jnp.concatenate`` promotes a bf16 cache state against float32
    inputs to float32."""
    K = w.shape[0]
    if init_state is None:
        init_state = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    dt = torch.promote_types(init_state.dtype, u.dtype)
    up = torch.cat([init_state.to(dt), u.to(dt)], dim=1)
    S = u.shape[1]
    y = sum(up[:, i:i + S, :] * w[i] for i in range(K))
    return y + b, up[:, up.shape[1] - (K - 1):, :]


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold past
    which x is returned as it is (``F.softplus`` has one)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_params(p, cfg, u):
    """u ``[B, T, di]`` (after conv and SiLU) -> dt ``[B, T, di]``, Bm /
    Cm ``[B, T, N]``, all float32."""
    R = cfg.dt_rank
    N = cfg.ssm.d_state
    xdbc = torch.einsum("btd,dk->btk", u, p["x_proj"]).float()
    dt_lo, Bm, Cm = torch.split(xdbc, [R, N, N], dim=-1)
    dt = softplus(torch.einsum("btr,rd->btd", dt_lo, p["dt_w"].float())
                  + p["dt_b"].float() - 4.0)
    return dt, Bm, Cm


def _chunk_scan(dA, dBu, h0):
    """dA, dBu ``[B, T, di, N]`` float32; h0 ``[B, di, N]``. Returns
    (hs ``[B, T, di, N]``, hT): ``h_t = dA_t h_{t-1} + dBu_t`` token by
    token. The reference combines the same pairs in an
    ``associative_scan`` tree, another order of the same products.
    ``unbind`` / ``stack`` keep the backward at one pass over the chunk
    (indexing each token would scatter each gradient into a zero tensor
    of the whole chunk)."""
    h, hs = h0, []
    for a, b in zip(dA.unbind(1), dBu.unbind(1)):
        h = a * h + b
        hs.append(h)
    return torch.stack(hs, 1), h


def chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk: ``chunk`` tokens, or the largest divisor of
    S below it."""
    T = min(chunk, S)
    while S % T:
        T -= 1
    return T


def mamba_seq(p, cfg, x, state=None, use_kernel=False):
    """Full-sequence mamba. x ``[B, S, d]``. Returns (y, {"conv", "h"}):
    the conv state in x's dtype and ``h`` ``[B, di, N]`` float32."""
    s = cfg.ssm
    B, S, d = x.shape
    di = s.expand * d
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    u, z = torch.split(xz, di, dim=-1)
    conv_state = None if state is None else state["conv"]
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    u = F.silu(u)

    A = -torch.exp(p["A_log"].float())                         # [di, N]
    D = p["D"].float()
    h0 = (torch.zeros((B, di, s.d_state), dtype=torch.float32,
                      device=x.device) if state is None else state["h"])

    if use_kernel:
        dt, Bm, Cm = _ssm_params(p, cfg, u)
        y, hT = ops.selective_scan(u.float().contiguous(), dt.contiguous(),
                                   Bm.contiguous(), Cm.contiguous(),
                                   A.contiguous(), D.contiguous(),
                                   h0.contiguous())
        y = y.to(x.dtype)
    else:
        def body(h, u_t):
            dt, Bm, Cm = _ssm_params(p, cfg, u_t)
            dA = torch.exp(dt[..., None] * A)                  # [B,T,di,N]
            dBu = (dt * u_t.float())[..., None] * Bm[:, :, None, :]
            hs, hT = _chunk_scan(dA, dBu, h)
            y = torch.einsum("btdn,btn->btd", hs, Cm)
            y = y + u_t.float() * D
            return hT, y.to(x.dtype)

        # each chunk recomputed in the backward pass, one at a time: the
        # reference's nested jax.checkpoint of its chunk scan body
        T = chunk_len(S, s.chunk)
        h, ys = h0, []
        for c in range(S // T):
            h, y_c = remat(body, h, u[:, c * T:(c + 1) * T])
            ys.append(y_c)
        hT, y = h, torch.cat(ys, dim=1)
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, {"conv": new_conv, "h": hT}


def mamba_decode(p, cfg, x, state):
    """Single-token decode. x ``[B, 1, d]``; state {"conv" ``[B, K-1,
    di]`` (the cache's dtype), "h" ``[B, di, N]`` float32}. Returns (y,
    the new state: conv in the promoted dtype, h float32)."""
    di = cfg.ssm.expand * cfg.d_model
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    u, z = torch.split(xz, di, dim=-1)
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])
    u = F.silu(u)
    dt, Bm, Cm = _ssm_params(p, cfg, u)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[:, 0, :, None] * A)                      # [B,di,N]
    dBu = (dt[:, 0] * u[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = dA * state["h"] + dBu
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
    y = y + u[:, 0].float() * p["D"].float()
    y = y.to(x.dtype)[:, None, :] * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, {"conv": new_conv, "h": h}


def mamba_state_defs(cfg, batch, dtype=torch.float32):
    """``{"conv": (shape, dtype), "h": (shape, float32)}``."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {"conv": ((batch, s.d_conv - 1, di), dtype),
            "h": ((batch, di, s.d_state), torch.float32)}
