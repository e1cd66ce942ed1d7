"""Checkpointing: per-leaf npy files + manifest, async writer.

Layout: ``<dir>/step_<n>/<leaf-path>.npy`` + ``manifest.json``. Writes
go through a temp directory + atomic rename, so a crash mid-write never
corrupts the latest checkpoint (restart safety). ``save(..., async_=True)``
hands serialization to a background thread — the train loop keeps
stepping while the previous state persists (fault-tolerance substrate).

The leaf names are the reference's, letter for letter (its ``_flatten``
names a NamedTuple field ``.<field>`` and a dict entry by its key,
joined by ``__``: ``.step``, ``.master__blocks__p0__ln1``, ...), so a
checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_SEP = "__"


def _paths(tree, prefix=()):
    """(path, leaf) pairs in the reference's flatten order: NamedTuple
    fields in order, dict keys sorted."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + ("." + name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    """{leaf name: leaf} in flatten order."""
    return {(_SEP.join(path) or "leaf"): leaf for path, leaf in _paths(tree)}


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of ``leaf`` do not reach."""
    return leaf.detach().to("cpu", copy=True).numpy()


def save(ckpt_dir: str, state: Any, step: int, async_: bool = False,
         keep: int = 3) -> Optional[threading.Thread]:
    """Write state at ``step``. Returns the writer thread when async.

    Every leaf is copied to host memory before this returns, so a step
    that updates the state in place after an async save does not reach
    the checkpoint."""
    host = {k: _to_host(v) for k, v in _flatten(state).items()}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for k, v in host.items():
            np.save(os.path.join(tmp, k + ".npy"), v)
            manifest["leaves"][k] = {"shape": list(v.shape), "dtype": str(v.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if async_:
        th = threading.Thread(target=_write, daemon=True)
        th.start()
        return th
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore_latest(ckpt_dir: str) -> Optional[dict]:
    """Returns {leaf_key: np.ndarray} of the newest intact checkpoint,
    and its step under ``"__step__"``."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {k: np.load(os.path.join(d, k + ".npy"))
           for k in manifest["leaves"]}
    out["__step__"] = step
    return out


def load_into(leaves: dict, state_template: Any) -> Any:
    """Fill the template's tensors, in place, from restored leaves (each
    cast to the template leaf's dtype, on its device) and return the
    template. A fresh ``init_state`` makes the template; the reference
    builds a new tree instead, which at full size would hold the state
    twice."""
    for k, tmpl in _flatten(state_template).items():
        v = leaves[k]
        if tuple(v.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {k} has shape {v.shape}, "
                             f"the state {tuple(tmpl.shape)}")
        with torch.no_grad():
            tmpl.copy_(torch.from_numpy(np.asarray(v)))
    return state_template
