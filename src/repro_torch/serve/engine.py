"""Serve engine: prefill + decode with a KV cache, batched generation,
RowClone-backed cache forks, and request-level straggler timeouts.

The engine drives the model zoo's ``prefill_fn`` / ``decode_fn``.
``fork_cache`` duplicates a finished prompt's KV pages for n
continuations: the serving-side bulk copy that the RowClone case study
models at the DRAM level. It goes through the ``rowclone_copy`` kernel by
default (``use_kernel=True``), the route the reference takes on its
accelerator; the reference defaults to ``jnp.tile`` only for its dry run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_KV_NAMES = ("k", "v", "self_k", "self_v")


def pad_cache_to(cache, s_max: int):
    """Pad attention-cache leaves ``[G, B, S, KV, hd]`` out to s_max
    along S with zeros (a new tree; other leaves are kept)."""
    def one(name, x):
        if isinstance(x, dict):
            return {k: one(k, v) for k, v in x.items()}
        if name in _KV_NAMES and x.dim() == 5 and x.shape[2] < s_max:
            return F.pad(x, (0, 0, 0, 0, 0, s_max - x.shape[2]))
        return x
    return one(None, cache)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    started: float = 0.0


class ServeEngine:
    """Generation over a built :class:`~repro_torch.models.model_zoo.Model`
    and its parameters, on the parameters' device."""

    def __init__(self, model, params, s_max: int,
                 straggler_timeout_s: float = 30.0):
        if model.cfg.family in ("vlm", "encdec"):
            raise NotImplementedError(
                f"the {model.cfg.family} family is not ported yet "
                f"(ROADMAP Queue A 12)")
        self.model = model
        self.params = params
        self.s_max = s_max
        self.timeout = straggler_timeout_s
        self.timeouts = 0

    def _greedy(self, logits):
        """``[B, 1]`` argmax over the real vocabulary (first index on ties,
        as ``jnp.argmax``)."""
        return logits[:, -1, :self.model.cfg.vocab_size].argmax(-1)[:, None]

    @torch.no_grad()
    def generate(self, prompt: np.ndarray, max_new: int) -> List[int]:
        """Single-request greedy generation (batch dim 1)."""
        logits, cache = self.model.prefill_fn(
            self.params, {"tokens": np.asarray(prompt)[None, :]})
        cache = pad_cache_to(cache, self.s_max)
        pos = prompt.shape[-1]
        tok = self._greedy(logits)
        out = [int(tok[0, 0])]
        t0 = time.perf_counter()
        for _ in range(max_new - 1):
            if time.perf_counter() - t0 > self.timeout:
                self.timeouts += 1   # straggler mitigation: give up the tail
                break
            logits, cache = self.model.decode_fn(self.params, cache, tok, pos)
            tok = self._greedy(logits)
            out.append(int(tok[0, 0]))
            pos += 1
        return out

    @torch.no_grad()
    def generate_batch(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """Batched generation, all prompts the same length."""
        B, S0 = prompts.shape
        logits, cache = self.model.prefill_fn(self.params,
                                              {"tokens": np.asarray(prompts)})
        cache = pad_cache_to(cache, self.s_max)
        pos = S0
        tok = self._greedy(logits)
        outs = [tok[:, 0]]
        for _ in range(max_new - 1):
            logits, cache = self.model.decode_fn(self.params, cache, tok, pos)
            tok = self._greedy(logits)
            outs.append(tok[:, 0])
            pos += 1
        return torch.stack(outs, dim=1).cpu().numpy()  # [B, max_new]

    @torch.no_grad()
    def fork_cache(self, cache, n: int, use_kernel: bool = True):
        """Duplicate a batch-1 cache into n continuations (beam / prefix
        fork).

        With ``use_kernel`` each 5-D leaf ``[G, 1, ...]`` (attention k /
        v) is copied n times by the ``rowclone_copy`` kernel, each copy
        straight into its slot of the ``[G, n, ...]`` output; the other
        leaves (a mamba position's ``conv`` / ``h``), and every leaf
        without ``use_kernel``, are tiled."""
        def one(x):
            if isinstance(x, dict):
                return {k: one(v) for k, v in x.items()}
            if x.dim() >= 2 and x.shape[1] == 1:
                if use_kernel and x.dim() == 5:
                    out = x.new_empty((x.shape[0], n) + tuple(x.shape[2:]))
                    flat = x.reshape(x.shape[0], -1)
                    slots = out.view(x.shape[0], n, -1)
                    for i in range(n):
                        ops.rowclone_copy(flat, out=slots[:, i])
                    return out
                reps = [1] * x.dim()
                reps[1] = n
                return x.repeat(reps)
            return x
        return one(cache)
