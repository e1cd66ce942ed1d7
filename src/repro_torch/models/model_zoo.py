"""Model zoo: build per-architecture functional models.

``build(cfg, s_max)`` returns a :class:`Model` whose functions train and
serve the decoder-only LM, dense, MoE or the mamba hybrid: ``loss_fn``
(train), ``prefill_fn`` and ``decode_fn`` (serve). The VLM and the
encoder-decoder are later slices of the port (ROADMAP Queue A 12) and
raise ``NotImplementedError``, as do rwkv layers.

The prefill takes the kernels by default (``use_flash=True``: the flash
kernel for attention, the selective-scan kernel for a mamba layer's
scan): the reference defaults to its jnp path only for its dry run,
which the port does not have. ``loss_fn`` always takes the plain
attention and the plain chunked scan, as the reference's models do (they
are built with ``use_flash=False``): neither kernel has a backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import pdefs
from repro_torch.models import transformer as tf
from repro_torch.models.layers import remat as _remat


def _ce_loss(cfg, logits, targets, mask=None):
    """fp32 CE with padded-vocab masking + z-loss."""
    logits = logits.float()
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    pad_bias = torch.where(vocab < cfg.vocab_size, 0.0, -1e9)
    logits = logits + pad_bias
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    z = 1e-4 * lse ** 2
    per_tok = nll + z
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (per_tok * mask).sum() / denom


def _block_len(S, target=512, align=16):
    """Largest block <= target dividing S, preferring SP-friendly multiples."""
    for bs in range(min(target, S), 0, -1):
        if S % bs == 0 and bs % align == 0:
            return bs
    for bs in range(min(target, S), 0, -1):
        if S % bs == 0:
            return bs
    return S


def _ce_loss_chunked(cfg, head_fn, h, targets, block=512):
    """Chunked CE: logits are materialized one seq-block at a time and
    recomputed in the backward pass (the full [B,S,V] fp32 logits tensor
    never exists). The mean of the blocks' means, summed in block order
    from 0 as the reference's scan does."""
    B, S, _ = h.shape
    bs = _block_len(S, block)
    nb = S // bs

    def body(hi, ti):
        return _ce_loss(cfg, head_fn(hi), ti)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nb):
        sl = slice(i * bs, (i + 1) * bs)
        tot = tot + _remat(body, h[:, sl], targets[:, sl])
    return tot / nb


@dataclasses.dataclass
class Model:
    cfg: Any
    s_max: int
    defs: Any
    loss_fn: Callable            # (params, batch) -> (loss, metrics)
    prefill_fn: Optional[Callable]   # (params, batch) -> (last_logits, cache)
    decode_fn: Optional[Callable]    # (params, cache, token, pos) -> (logits, cache)

    def init(self, seed: int = 0, dtype=torch.float32, device=None):
        """Parameters drawn from ``torch.Generator(device).manual_seed(seed)``
        on ``device`` (``None`` means CUDA)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pdefs.init_tree(gen, self.defs, dtype)

    def n_params(self) -> int:
        return pdefs.count_params(self.defs)


def _build_lm(cfg, s_max, use_flash=True, remat=True,
              cache_dtype=torch.bfloat16):
    defs = tf.lm_defs(cfg)

    def loss_fn(params, batch):
        """(loss, {"ce", "moe_aux", "moe_z"}); ``batch`` holds int
        ``tokens`` and ``targets`` ``[B, S]`` on any device (moved to the
        parameters'). The loss is ``ce + moe_aux + moe_z``, the aux terms
        summed over the MoE layers (0 for a dense model)."""
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        targets = torch.as_tensor(batch["targets"], device=dev)
        x = tf.embed_tokens(params, cfg, tokens)
        positions = torch.arange(x.shape[1], device=dev)
        h, aux = tf.forward_train(params, cfg, x, positions, remat=remat,
                                  use_flash=False)
        ce = _ce_loss_chunked(
            cfg, lambda hi: tf.logits_from_hidden(params, cfg, hi), h,
            targets)
        loss = ce + aux["moe_aux"] + aux["moe_z"]
        return loss, {"ce": ce, "moe_aux": aux["moe_aux"],
                      "moe_z": aux["moe_z"]}

    def prefill_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        x = tf.embed_tokens(params, cfg, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        h, cache = tf.forward_prefill(params, cfg, x, positions,
                                      s_max=x.shape[1],
                                      cache_dtype=cache_dtype,
                                      use_flash=use_flash)
        logits = tf.logits_from_hidden(params, cfg, h[:, -1:, :])
        return logits, cache

    def decode_fn(params, cache, token, pos: int):
        token = torch.as_tensor(token, device=params["embed"].device).long()
        x = tf.embed_tokens(params, cfg, token)
        h, cache = tf.forward_decode(params, cfg, x, int(pos), cache)
        return tf.logits_from_hidden(params, cfg, h), cache

    return Model(
        cfg=cfg, s_max=s_max, defs=defs,
        loss_fn=loss_fn, prefill_fn=prefill_fn, decode_fn=decode_fn)


def build(cfg, s_max: int, use_flash: bool = True, remat: bool = True,
          cache_dtype=torch.bfloat16) -> Model:
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP Queue A 12)")
    return _build_lm(cfg, s_max, use_flash, remat, cache_dtype)
