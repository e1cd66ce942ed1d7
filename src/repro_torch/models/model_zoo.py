"""Model zoo: build per-architecture functional models.

``build(cfg, s_max)`` returns a :class:`Model` whose functions serve the
decoder-only dense LM: ``prefill_fn`` and ``decode_fn``. Training
(``loss_fn``), the VLM and the encoder-decoder are later slices of the
port (ROADMAP Queue A 12) and raise ``NotImplementedError``.

The prefill takes the flash kernel by default (``use_flash=True``): the
reference defaults to its jnp path only for its dry run, which the port
does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import pdefs
from repro_torch.models import transformer as tf


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


def _build_lm(cfg, s_max, use_flash=True, cache_dtype=torch.bfloat16):
    defs = tf.lm_defs(cfg)

    def loss_fn(params, batch):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP Queue A 12: loss_fn, "
            "train/, data/, checkpoint/)")

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


def build(cfg, s_max: int, use_flash: bool = True,
          cache_dtype=torch.bfloat16) -> Model:
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP Queue A 12)")
    return _build_lm(cfg, s_max, use_flash, cache_dtype)
