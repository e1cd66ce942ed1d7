"""Error-feedback int8 gradient compression (opt-in).

Per-leaf symmetric int8 quantization with a persistent error-feedback
accumulator: the quantization residual is carried into the next step, so
the *accumulated* update is unbiased (EF-SGD style). In the reference it
runs before the ZeRO-1 reduce-scatter, to halve the collective's bytes
against bf16; the port has no collective yet (ROADMAP Queue A 13), so
``make_train_step(grad_compressor=...)`` applies it on one device.
"""
from __future__ import annotations

import torch

from repro_torch.models import pdefs


def quantize_int8(x: torch.Tensor):
    """(int8 q, float32 scale) with ``x ~ q * scale``, round half to even."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def make_ef_compressor():
    """Returns (compress(grads, ef_state) -> (grads', ef_state'), init_ef)."""

    def init_ef(grads_like):
        return pdefs.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads_like)

    def compress(grads, ef):
        def one(g, e):
            v = g.float() + e
            deq = dequantize(*quantize_int8(v))
            return deq.to(g.dtype), v - deq

        pairs = pdefs.tree_leaves(pdefs.tree_map(one, grads, ef))
        return (pdefs.tree_unflatten(grads, [p[0] for p in pairs]),
                pdefs.tree_unflatten(grads, [p[1] for p in pairs]))

    return compress, init_ef


def simple_compressor(grads):
    """Stateless variant for make_train_step(grad_compressor=...)."""
    def one(g):
        return dequantize(*quantize_int8(g.float())).to(g.dtype)
    return pdefs.tree_map(one, grads)
