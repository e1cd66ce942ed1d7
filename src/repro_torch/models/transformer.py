"""Decoder stack over layer groups with a block pattern per group.

A *pattern* of period P describes each layer position's (mixer, mlp)
pair; parameters are stacked over ``n_layers // P`` groups, and the
forward passes loop over the groups (the reference scans them with
``lax.scan``). The port builds attention and mamba mixers with dense or
MoE MLPs (dense and MoE models have P = 1; jamba P = 8: 7 mamba, 1
attention at position 4, MoE on odd positions); rwkv positions raise
``NotImplementedError`` (ROADMAP Queue A 12). ``forward_train`` is
differentiable (``loss_fn``) and returns the MoE aux losses summed over
the layers; the prefill and decode run under ``torch.no_grad``.

Parameters and caches are nested dicts of tensors with the reference's
structure and its stacked ``[G, ...]`` axis, so the reference's trees
carry over leaf for leaf (``repro_torch.interop``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import pdefs
from repro_torch.models.pdefs import ParamDef, stack_defs


# ---------------- pattern ----------------

def layer_pattern(cfg) -> Tuple[Tuple[str, str], ...]:
    moe_every = cfg.moe.every if cfg.moe else 1
    P = 1
    for k in (cfg.attn_every, moe_every):
        P = P * k // math.gcd(P, k)
    out = []
    for p in range(P):
        if cfg.attn_free:
            mixer = "rwkv"
        elif cfg.ssm is not None and cfg.attn_every > 1:
            mixer = "attn" if p % cfg.attn_every == cfg.attn_every // 2 else "mamba"
        else:
            mixer = "attn"
        if cfg.attn_free:
            mlp = "rwkv_cm"
        elif cfg.moe and p % moe_every == moe_every - 1:
            mlp = "moe"
        else:
            mlp = "dense"
        out.append((mixer, mlp))
    if cfg.n_layers % P:
        raise ValueError(f"{cfg.n_layers} layers do not divide into groups "
                         f"of {P}")
    return tuple(out)


def n_groups(cfg) -> int:
    return cfg.n_layers // len(layer_pattern(cfg))


_NOT_PORTED = {
    "rwkv": "rwkv time mix is not ported yet (ROADMAP Queue A 12: rwkv)",
    "rwkv_cm": "rwkv channel mix is not ported yet (ROADMAP Queue A 12: rwkv)",
}


def _check_ported(pat) -> None:
    for mx, ml in pat:
        for part in (mx, ml):
            if part in _NOT_PORTED:
                raise NotImplementedError(_NOT_PORTED[part])


# ---------------- parameter definitions ----------------

def _pos_defs(cfg, mixer, mlp):
    _check_ported(((mixer, mlp),))
    d = cfg.d_model
    return {"ln1": ParamDef((d,), ("hidden",), init="zeros"),
            "ln2": ParamDef((d,), ("hidden",), init="zeros"),
            "mixer": (mb.mamba_defs(cfg) if mixer == "mamba"
                      else attn.attn_defs(cfg)),
            "mlp": (moe_mod.moe_defs(cfg) if mlp == "moe"
                    else L.mlp_defs(d, cfg.d_ff, cfg.act))}


def lm_defs(cfg, std=0.02):
    pat = layer_pattern(cfg)
    G = n_groups(cfg)
    blocks = {f"p{i}": stack_defs(_pos_defs(cfg, mx, ml), G)
              for i, (mx, ml) in enumerate(pat)}
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "hidden"), std=std),
        "final_norm": ParamDef((cfg.d_model,), ("hidden",), init="zeros"),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.padded_vocab), ("hidden", "vocab"), std=std)
    return defs


def group_params(blocks, g: int):
    """Group ``g``'s slice of the stacked ``[G, ...]`` parameters."""
    if isinstance(blocks, dict):
        return {k: group_params(v, g) for k, v in blocks.items()}
    return blocks[g]


def unstack_groups(blocks, G: int) -> list:
    """The stacked ``[G, ...]`` parameters as G per-group trees of views,
    one ``unbind`` a leaf. Under autograd its backward stacks the G
    groups' gradients once, where indexing each group would scatter each
    gradient into a zero tensor of the whole stack."""
    per_leaf = pdefs.tree_map(lambda t: t.unbind(0), blocks)
    return [pdefs.tree_map(lambda u, g=g: u[g], per_leaf) for g in range(G)]


# ---------------- caches ----------------

def cache_specs(cfg, batch: int, s_max: int, dtype=torch.bfloat16):
    """``{"p<i>": {name: (shape, dtype)}}`` per pattern position, each
    shape with the leading ``G`` axis: an attention position's ``"k"``
    and ``"v"`` ``[G, B, S, KV, hd]`` in ``dtype``; a mamba position's
    ``"conv"`` ``[G, B, K-1, di]`` in ``dtype`` and ``"h"`` ``[G, B, di,
    N]`` in float32."""
    pat = layer_pattern(cfg)
    _check_ported(pat)
    G = n_groups(cfg)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    kv = (G, batch, s_max, KV, hd)
    out = {}
    for i, (mx, _) in enumerate(pat):
        if mx == "mamba":
            out[f"p{i}"] = {name: ((G,) + shape, dt) for name, (shape, dt)
                            in mb.mamba_state_defs(cfg, batch, dtype).items()}
        else:
            out[f"p{i}"] = {"k": (kv, dtype), "v": (kv, dtype)}
    return out


def init_cache(cfg, batch, s_max, dtype=torch.bfloat16, device=None):
    return {pos: {name: torch.zeros(shape, dtype=dt, device=device)
                  for name, (shape, dt) in leaves.items()}
            for pos, leaves in cache_specs(cfg, batch, s_max, dtype).items()}


# ---------------- forward ----------------

def _rope_sc(cfg, positions):
    if cfg.rope_theta <= 0:
        return None
    return L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _mlp(cfg, ml, p, h):
    """The position's MLP: (y, aux) with the MoE aux losses, or None."""
    if ml == "moe":
        return moe_mod.moe_apply(p, cfg, h)
    return L.mlp_apply(p, h, cfg.act), None


def _sublayer(cfg, mx, ml, p, x, rope_sc, use_flash):
    """One layer position over a full sequence: (x, state, aux) with the
    mixer's new cache entries (attention ``(k, v)``, mamba ``{"conv",
    "h"}``) and the MoE aux losses (None for a dense MLP)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mx == "mamba":
        y, st = mb.mamba_seq(p["mixer"], cfg, h, use_kernel=use_flash)
    else:
        y, st = attn.attn_apply(p["mixer"], cfg, h, rope_sc, causal=True,
                                use_flash=use_flash)
    x = x + y
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, a = _mlp(cfg, ml, p["mlp"], h)
    return x + y, st, a


def _block_seq(cfg, pat, params_g, x, rope_sc, use_flash, mode="prefill"):
    """Apply one pattern group over a full sequence. Returns (x, states,
    aux): for a prefill each position's new cache entries in the compute
    dtype (attention ``(k, v)``, mamba ``{"conv", "h"}``), None in
    ``mode="train"`` (nothing kept past the group); aux the group's MoE
    aux losses summed over its positions (0.0 without an MoE position).

    In training a group of more than one position recomputes each
    position in the backward pass (the reference's ``inner_ckpt``), so
    the group's backward holds one position's recompute at a time."""
    states = {} if mode == "prefill" else None
    aux = {"moe_aux": 0.0, "moe_z": 0.0}
    inner = mode == "train" and len(pat) > 1
    for i, (mx, ml) in enumerate(pat):
        args = (cfg, mx, ml, params_g[f"p{i}"], x, rope_sc, use_flash)
        x, st, a = L.remat(_sublayer, *args) if inner else _sublayer(*args)
        if states is not None:
            states[f"p{i}"] = st
        if a is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    return x, states, aux


def _block_decode(cfg, pat, params_g, x, rope_sc, cache_g, pos: int):
    """One pattern group, single-token decode; updates ``cache_g`` (this
    group's slices: ``[B, S, KV, hd]`` k / v, mamba ``conv`` / ``h``) in
    place, each new state cast to its leaf's dtype. Returns x."""
    for i, (mx, ml) in enumerate(pat):
        p = params_g[f"p{i}"]
        c = cache_g[f"p{i}"]
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        if mx == "mamba":
            y, st = mb.mamba_decode(p["mixer"], cfg, h, c)
            c["conv"].copy_(st["conv"])
            c["h"].copy_(st["h"])
        else:
            y, _ = attn.attn_decode(p["mixer"], cfg, h, rope_sc, c["k"],
                                    c["v"], pos)
        x = x + y
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _mlp(cfg, ml, p["mlp"], h)[0]
    return x


def forward_train(params, cfg, x, positions, remat=True, use_flash=True):
    """x ``[B, S, d]`` embedded input -> (final-normed hidden states,
    {"moe_aux", "moe_z"}): the MoE aux losses summed over the groups,
    float32 scalars (0 without an MoE position).

    With ``remat`` each layer group is recomputed in the backward pass
    (the reference's ``jax.checkpoint`` of its scan body), so only the
    groups' inputs are kept; the recompute routes as the first pass did
    (``moe_apply``'s forward is deterministic). ``loss_fn`` passes
    ``use_flash=False``: the flash kernel has no backward."""
    pat = layer_pattern(cfg)
    rope_sc = _rope_sc(cfg, positions)

    def body(x, params_g):
        x, _, aux = _block_seq(cfg, pat, params_g, x, rope_sc, use_flash,
                               mode="train")
        return x, aux["moe_aux"], aux["moe_z"]

    am = az = torch.zeros((), dtype=torch.float32, device=x.device)
    for params_g in unstack_groups(params["blocks"], n_groups(cfg)):
        x, a, z = L.remat(body, x, params_g) if remat else body(x, params_g)
        am, az = am + a, az + z
    return (L.rms_norm(x, params["final_norm"], cfg.norm_eps),
            {"moe_aux": am, "moe_z": az})


def forward_prefill(params, cfg, x, positions, s_max,
                    cache_dtype=torch.bfloat16, use_flash=True):
    """Returns (hidden, cache). Prompt length must equal s_max for the
    attention cache; k / v and mamba ``conv`` are stored in
    ``cache_dtype``, mamba ``h`` in float32."""
    pat = layer_pattern(cfg)
    if x.shape[1] != s_max:
        raise ValueError(f"prefill of {x.shape[1]} tokens into an "
                         f"{s_max}-slot cache")
    rope_sc = _rope_sc(cfg, positions)
    cache = init_cache(cfg, x.shape[0], s_max, cache_dtype, x.device)
    for g in range(n_groups(cfg)):
        x, states, _ = _block_seq(cfg, pat,
                                  group_params(params["blocks"], g), x,
                                  rope_sc, use_flash)
        for pos, st in states.items():
            if isinstance(st, tuple):
                st = dict(zip(("k", "v"), st))
            for name, t in st.items():
                cache[pos][name][g] = t     # cast to the leaf's dtype
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def forward_decode(params, cfg, x, pos: int, cache):
    """x ``[B, 1, d]``; pos: the token's position. Returns (hidden,
    cache), the cache updated in place."""
    pat = layer_pattern(cfg)
    rope_sc = _rope_sc(cfg, torch.tensor([pos], device=x.device))
    for g in range(n_groups(cfg)):
        cache_g = group_params(cache, g)
        x = _block_decode(cfg, pat, group_params(params["blocks"], g), x,
                          rope_sc, cache_g, pos)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def logits_from_hidden(params, cfg, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def embed_tokens(params, cfg, tokens):
    x = L.embed_apply(params["embed"], tokens)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x
