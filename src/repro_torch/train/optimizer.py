"""AdamW with mixed-precision master weights.

The optimizer state is the float32 master copy of the parameters and
Adam's m and v, also float32; the step computes in a compute copy
(bf16 by default, ``trainer.make_train_step``). The schedule, the bias
corrections and the clip scale are float32 tensors on the state's
device, computed as the reference computes them in JAX (never in host
doubles). ``apply_update`` updates master, m and v in place: the
reference donates its state to the step, and at full size a second copy
would not fit beside the first.

The reference's ZeRO-1 specs (``zero1_pspecs``, ``abstract_state``,
``state_pspecs``) shard the state over a device mesh; the port runs on
one device and has none of them yet (ROADMAP Queue A 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models import pdefs


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    master: Any
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params_fp32) -> AdamWState:
    """Step 0, the parameters as the master copy (not copied), m and v
    zero."""
    dev = pdefs.tree_leaves(params_fp32)[0].device
    zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      master=params_fp32, m=pdefs.tree_map(zeros, params_fp32),
                      v=pdefs.tree_map(zeros, params_fp32))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32, summed
    leaf by leaf in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pdefs.tree_leaves(tree)))


def apply_update(cfg: AdamWConfig, state: AdamWState, grads) -> tuple:
    """grads: float32, the master's structure. Updates ``state``'s
    master, m and v in place and returns ``(new_state, metrics)``, the
    new state holding the same tensors and a new step."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(b1, step.to(torch.float32))
    c2 = 1 - torch.pow(b2, step.to(torch.float32))

    with torch.no_grad():
        for g, m, v, p in zip(pdefs.tree_leaves(grads),
                              pdefs.tree_leaves(state.m),
                              pdefs.tree_leaves(state.v),
                              pdefs.tree_leaves(state.master)):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
                + cfg.weight_decay * p
            p.sub_(lr * upd)
    return (AdamWState(step=step, master=state.master, m=state.m, v=state.v),
            {"grad_norm": gn, "lr": lr})
