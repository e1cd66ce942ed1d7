"""Top-k MoE with capacity: routing, dispatch and combine, aux losses.

Computes what ``repro.models.moe`` computes. Tokens regroup per sequence
row into dispatch groups of ``M`` tokens (``group_len``); in each group
the router's float32 softmax picks ``top_k`` experts a token, ties to
the lower expert index as ``jax.lax.top_k`` breaks them; the gates are
the picked probabilities renormalised to sum to one. Each (token, k)
choice takes the next slot of its expert's queue in (token, k) order,
and a choice past the expert's ``capacity`` is dropped: it adds nothing
to the output, and the kept gates are not renormalised again.

The reference dispatches and combines through one-hot ``[G, S, E, C]``
einsums. Here both are gathers of the same rows: the token in slot c of
expert e (``torch.searchsorted`` on the per-expert running count of
choices), and each choice's expert output, summed over k in order. The
forward pass has no scatter and no atomics, so a recompute under remat
routes and sums exactly as the first pass did; the backward of a gather
scatter-adds. The expert products are batched matmuls over
``[G, E, C]`` rows, as the reference's einsums.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation
from repro_torch.models.pdefs import ParamDef


def moe_defs(cfg, std=0.02):
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_ff
    defs = {
        "router": ParamDef((d, E), ("hidden", "experts"), std=std),
        "up": ParamDef((E, d, f), ("experts", "hidden", "ffn"), std=std),
        "down": ParamDef((E, f, d), ("experts", "ffn", "hidden"), std=std),
    }
    if cfg.act in ("swiglu", "geglu"):
        defs["gate"] = ParamDef((E, d, f), ("experts", "hidden", "ffn"), std=std)
    return defs


def capacity(tokens_per_group: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(math.ceil(tokens_per_group * top_k * cf / n_experts))
    return max(c, 1)


def group_len(seq_len: int, group_size: int) -> int:
    """Tokens per dispatch group: ``group_size``, or less, down to the
    largest length that divides the sequence (250 for 1000 tokens, 1 for
    a decode step)."""
    M = min(group_size, seq_len)
    while seq_len % M:
        M -= 1
    return M


def top_k(probs, k: int):
    """The k largest along the last axis, largest first, equal values in
    index order (``jax.lax.top_k``; ``torch.topk`` leaves the order of
    ties unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    logits: torch.Tensor       # [G, M, E] float32
    probs: torch.Tensor        # [G, M, E] float32
    gates: torch.Tensor        # [G, M, K] float32, renormalised
    expert_idx: torch.Tensor   # [G, M, K] int64
    slot: torch.Tensor         # [G, M, K] position in the expert's queue
    keep: torch.Tensor         # [G, M, K] bool, slot < capacity
    running: torch.Tensor      # [G, M * K, E] int32: each expert's count of
    #                            choices up to each (token, k), in that order
    capacity: int


def route(p, cfg, x) -> Routing:
    """Routing of the groups ``x [G, M, d]``: the router's product in x's
    dtype, then float32."""
    m = cfg.moe
    G, M, _ = x.shape
    E, K = m.n_experts, m.top_k
    C = capacity(M, E, K, m.capacity_factor)
    logits = torch.einsum("gsd,de->gse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, E).to(torch.int32).view(G, M * K, E)
    running = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    slot = torch.gather(running, 2, idx.reshape(G, M * K, 1)).view(
        G, M, K) - 1
    return Routing(logits, probs, gates, idx, slot, slot < C, running, C)


def aux_losses(cfg, r: Routing) -> dict:
    """Switch load balance (dropped choices counted, every group and
    token in the means) and the router z-loss, float32 scalars."""
    m = cfg.moe
    E = m.n_experts
    G, M, _ = r.probs.shape
    me = r.probs.mean(dim=(0, 1))
    ce = r.running[:, -1].sum(0).float() / (G * M)
    aux = E * torch.sum(me * ce) * m.aux_coef
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2) * m.router_z_coef
    return {"moe_aux": aux, "moe_z": z}


def _rows(table, index):
    """``table [G, N, d]`` rows at ``index [G, L]`` -> ``[G, L, d]`` (a
    gather; its backward is ``index_add_``)."""
    G, N, d = table.shape
    base = torch.arange(G, device=index.device)[:, None] * N
    return torch.index_select(table.reshape(G * N, d), 0,
                              (index + base).reshape(-1)).view(
        G, index.shape[1], d)


def moe_apply(p, cfg, x) -> Tuple[torch.Tensor, dict]:
    """x ``[B, S, d]`` -> (y, {"moe_aux", "moe_z"})."""
    m = cfg.moe
    B0, S0, d = x.shape
    M = group_len(S0, m.group_size)
    x = x.reshape(B0 * (S0 // M), M, d)
    G = x.shape[0]
    E, K = m.n_experts, m.top_k
    r = route(p, cfg, x)
    C = r.capacity

    # dispatch: the token holding slot c of expert e is the one whose
    # choice brought e's running count to c + 1; an empty slot reads the
    # zero row appended at index M
    want = torch.arange(1, C + 1, dtype=torch.int32, device=x.device)
    pos = torch.searchsorted(r.running.transpose(1, 2).contiguous(),
                             want.expand(G, E, C).contiguous())
    tok = torch.where(pos < M * K, pos // K, M).view(G, E * C)
    xz = torch.cat([x, x.new_zeros(G, 1, d)], dim=1)
    xe = _rows(xz, tok).view(G, E, C, d)

    h = torch.einsum("gecd,edf->gecf", xe, p["up"])
    if "gate" in p:
        h = activation(cfg.act, h, torch.einsum("gecd,edf->gecf", xe,
                                                p["gate"]))
    else:
        h = activation(cfg.act, h)
    ye = torch.einsum("gecf,efd->gecd", h, p["down"])

    # combine: each kept choice reads its expert's output row, a dropped
    # one the zero row at index E * C; the gates are rounded to x's dtype,
    # the products summed over k in order in float32 and rounded once
    yz = torch.cat([ye.reshape(G, E * C, d), ye.new_zeros(G, 1, d)], dim=1)
    at = torch.where(r.keep, r.expert_idx * C + r.slot, E * C)
    yk = _rows(yz, at.view(G, M * K)).view(G, M, K, d)
    w = r.gates.to(x.dtype).float()
    y = yk[:, :, 0].float() * w[:, :, 0, None]
    for k in range(1, K):
        y = y + yk[:, :, k].float() * w[:, :, k, None]
    return y.to(x.dtype).reshape(B0, S0, d), aux_losses(cfg, r)
