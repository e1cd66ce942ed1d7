"""Shared layer primitives: norms, RoPE, activations, GLU MLP, embeddings.

Each function computes what its namesake in ``repro.models.layers`` does,
in the same dtypes (norms and RoPE in float32, the result in x's dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.pdefs import ParamDef


def remat(fn, *args):
    """``jax.checkpoint(fn)(*args)``: the activations inside ``fn`` are not
    kept for the backward pass but recomputed there (the model has no
    randomness, so no RNG state is saved). A plain call when autograd
    records nothing (serving runs under ``torch.no_grad``)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def rms_norm(x, weight, eps):
    """Scale by ``1 + weight`` (zero-initialised weight = identity)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layer_norm(x, weight, bias, eps):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


# ---------------- RoPE ----------------

def rope_tables(positions, head_dim, theta):
    """positions: int ``[...]``. Returns (sin, cos) of shape
    ``[..., head_dim // 2]``, float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: ``[B, S, H, D]``; sin/cos: ``[B, S, D//2]`` or ``[S, D//2]``."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:   # [S, half] -> broadcast over batch and heads
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    else:                # [B, S, half]
        sin = sin[:, :, None, :]
        cos = cos[:, :, None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(dt)


# ---------------- activations ----------------

def activation(name, x, gate=None):
    """``jax.nn.gelu`` defaults to the tanh approximation, so GELU here is
    ``approximate="tanh"`` (torch's default is the exact erf form)."""
    if name == "swiglu":
        return F.silu(gate) * x
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * x
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(name)


# ---------------- GLU MLP ----------------

def mlp_defs(d_model, d_ff, act, std=0.02):
    gated = act in ("swiglu", "geglu")
    defs = {
        "up": ParamDef((d_model, d_ff), ("hidden", "ffn"), std=std),
        "down": ParamDef((d_ff, d_model), ("ffn", "hidden"), std=std),
    }
    if gated:
        defs["gate"] = ParamDef((d_model, d_ff), ("hidden", "ffn"), std=std)
    return defs


def mlp_apply(p, x, act):
    h = x @ p["up"]
    if "gate" in p:
        h = activation(act, h, x @ p["gate"])
    else:
        h = activation(act, h)
    return h @ p["down"]


# ---------------- embeddings ----------------

def embed_apply(table, tokens, scale=None):
    y = table[tokens]
    if scale is not None:
        y = y * scale
    return y
