"""Single-source-of-truth parameter definitions.

Each parameter is declared once as a :class:`ParamDef` carrying its shape,
*logical* axis names and init recipe. A (nested) dict of ParamDefs gives
the concrete parameters (:func:`init_tree`, a dict of tensors of the same
structure) and the parameter count. The reference's ``pspec_tree`` and
``abstract_tree`` serve sharding and the dry run, which the port does not
have (ROADMAP Queue A 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"                 # normal | zeros | ones | hippo
    std: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of a nested dict (keys in sorted order,
    as ``jax.tree_util`` orders them), and over the same leaves of
    ``rest``, trees of the same structure: ``fn(leaf, *rest_leaves)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_tree(generator: torch.Generator, defs, dtype=torch.float32,
              device=None):
    """Concrete parameters for ``defs`` on ``generator``'s device (or
    ``device``): normal x std, zeros, ones, or ``"hippo"`` (the S4D-real
    init of a mamba ``A_log``: ``log(n + 1)`` along the last dim,
    broadcast over the leading dims). The draws differ from the
    reference's ``jax.random`` ones; tests carry the reference's weights
    over with :func:`repro_torch.interop.lm_params_from_numpy`."""
    dev = torch.device(device) if device is not None else generator.device

    def one(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        if d.init == "hippo":
            row = torch.log(torch.arange(1, d.shape[-1] + 1,
                                         dtype=torch.float32, device=dev))
            return row.expand(d.shape).to(dtype).contiguous()
        if d.init != "normal":
            raise ValueError(f"unknown init {d.init!r}")
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev).mul_(d.std)
        return x.to(dtype)
    return tree_map(one, defs)


def stack_defs(defs, n: int, axis_name: Optional[str] = None):
    """Prepend a stacking dim (one slice per layer group) to every ParamDef."""
    return tree_map(lambda d: ParamDef((n,) + d.shape,
                                       (axis_name,) + d.logical, d.init,
                                       d.std), defs)


def count_params(defs) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))
