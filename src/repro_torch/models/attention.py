"""GQA attention: qk-norm, qkv-bias, RoPE, KV cache, the flash kernel.

The reference keeps its pure-jnp path as the default only because its
dry run lowers that path for ``cost_analysis``. The port has no dry run,
so :func:`attn_apply` takes the flash kernel by default
(``use_flash=True``, which the reference keeps "for TPU runs"). Training
takes the plain path (``use_flash=False``), as the reference's models
do: its flash kernel has no backward, and neither has the port's (the
wrapper raises under autograd). Cross attention (``cross_attn_apply``,
``cross_kv``) waits for the encoder-decoder (ROADMAP Queue A 12).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, remat, rms_norm
from repro_torch.models.pdefs import ParamDef

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking


def attn_defs(cfg, std=0.02):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, H, hd), ("hidden", "heads", "head_dim"), std=std),
        "wk": ParamDef((d, KV, hd), ("hidden", "kv_heads", "kv_head_dim"), std=std),
        "wv": ParamDef((d, KV, hd), ("hidden", "kv_heads", "kv_head_dim"), std=std),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "hidden"), std=std),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((KV, hd), ("kv_heads", "kv_head_dim"), init="zeros")
        defs["bv"] = ParamDef((KV, hd), ("kv_heads", "kv_head_dim"), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="zeros")
        defs["k_norm"] = ParamDef((hd,), (None,), init="zeros")
    return defs


def _project_qkv(p, cfg, x, rope_sc):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope_sc is not None:
        sin, cos = rope_sc
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q ``[B, Sq, H, hd]``, k / v ``[B, Sk, KV, hd]``; GQA by head-group
    reshape, float32 softmax.

    The casts are the ones JAX's promotion makes, written out: q.k runs
    in float32 (a float32 q against the bf16 decode cache promotes), the
    probabilities are rounded to v's dtype, and the product with v stays
    in that dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    dt = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.to(dt), k.to(dt)).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, hd)


def _sdpa_chunked(q, k, v, causal, scale, block_q=512):
    """Query-blocked exact attention: scores materialize per q-block only,
    and under autograd each block is recomputed in the backward pass (the
    reference's ``jax.checkpoint`` of its scan body), so no block's
    scores outlive it."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    bq = min(block_q, Sq)
    if Sq % bq:  # non-power-of-two seq (e.g. whisper's 1500 frames)
        for cand in range(min(block_q, Sq), 0, -1):
            if Sq % cand == 0:
                bq = cand
                break

    def block(i, qi, k, v):
        mask = None
        if causal:
            qpos = i * bq + torch.arange(bq, device=q.device)
            mask = (qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
                    )[None, None, None]
        return _sdpa(qi, k, v, mask, scale)

    outs = [remat(block, i, q[:, i * bq:(i + 1) * bq], k, v)
            for i in range(Sq // bq)]
    return torch.cat(outs, dim=1)


def attn_apply(p, cfg, x, rope_sc, causal=True, use_flash=True):
    """Full-sequence attention (train / prefill). Returns (out, (k, v))."""
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    q, k, v = _project_qkv(p, cfg, x, rope_sc)
    S = x.shape[1]
    # the reference's routing: the flash kernel takes query lengths that
    # are a multiple of 128 and key lengths up to ops.MAX_KV_KERNEL
    if use_flash and S % 128 == 0 and S <= ops.MAX_KV_KERNEL:
        out = ops.flash_attention(q, k, v, causal=causal)
    elif use_flash or S > 1024:
        out = _sdpa_chunked(q, k, v, causal, scale)
    else:
        mask = None
        if causal:
            mask = torch.ones((S, S), dtype=torch.bool,
                              device=x.device).tril()[None, None, None]
        out = _sdpa(q, k, v, mask, scale)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def attn_decode(p, cfg, x, rope_sc, cache_k, cache_v, pos: int):
    """Single-token decode. x ``[B, 1, d]``; cache ``[B, S, KV, hd]``.

    Writes the new k / v into the cache at ``pos`` in place (the
    reference returns an updated copy, which XLA also updates in place)
    and returns ``(out, (cache_k, cache_v))``. ``pos`` past the cache
    raises, where the reference's update would clamp it."""
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    S = cache_k.shape[1]
    if not 0 <= pos < S:
        raise IndexError(f"decode position {pos} outside the {S}-slot cache")
    q, k, v = _project_qkv(p, cfg, x, rope_sc)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    valid = (torch.arange(S, device=x.device) <= pos)[None, None, None, None, :]
    out = _sdpa(q, cache_k, cache_v, valid, scale)
    out = torch.einsum("bshk,hkd->bsd", out.to(p["wo"].dtype), p["wo"])
    return out, (cache_k, cache_v)
