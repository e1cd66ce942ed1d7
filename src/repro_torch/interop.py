"""Carry the reference package's objects into the port.

Inputs are plain Python and numpy (what ``dataclasses.asdict`` and
``to_host`` give), so this module imports nothing of the reference
package: tests build a configuration, trace, program or filter once on
that side and hand the same values to both.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.dram import Geometry, Timing
from repro_torch.core.emulator import Trace
from repro_torch.core.faults import FaultModel
from repro_torch.core.smcprog import PolicyProgram
from repro_torch.core.state import TRACE_FIELDS, EmulatorState, StreamState
from repro_torch.core.timescale import SystemConfig
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWState

__all__ = ["system_config_from_dict", "trace_from_arrays",
           "policy_from_fields", "bloom_from_words", "EmulatorState",
           "stream_state_from_host",
           "lm_params_from_numpy", "cache_from_numpy", "tensor_from_numpy",
           "adamw_state_from_numpy"]


def policy_from_fields(table, score_reg: int, boost_reg: int = -1,
                       mitigate_reg: int = -1, base_cycles: int = 300,
                       cycles_per_op: int = 25,
                       smc_cycles_override: Optional[int] = None,
                       name: str = "policy") -> PolicyProgram:
    """A program from its table rows and registers (validated)."""
    return PolicyProgram(
        table=tuple(tuple(int(x) for x in r) for r in table),
        score_reg=int(score_reg), boost_reg=int(boost_reg),
        mitigate_reg=int(mitigate_reg), base_cycles=int(base_cycles),
        cycles_per_op=int(cycles_per_op),
        smc_cycles_override=(None if smc_cycles_override is None
                             else int(smc_cycles_override)),
        name=name).validate()


def system_config_from_dict(d: dict) -> SystemConfig:
    """``dataclasses.asdict`` of a reference ``SystemConfig`` (nested
    timing / geometry dicts, the policy as its fields or None, the fault
    model as its fields or None) -> the port's config."""
    d = dict(d)
    d["timing"] = Timing(**d["timing"])
    d["geometry"] = Geometry(**d["geometry"])
    if d.get("policy") is not None:
        d["policy"] = policy_from_fields(**d["policy"])
    if d.get("faults") is not None:
        d["faults"] = FaultModel(**d["faults"]).validate()
    return SystemConfig(**d)


def trace_from_arrays(kind, bank, row, delta, dep=None) -> Trace:
    return Trace.of(kind, bank, row, delta, dep)


def bloom_from_words(bits, m_bits: int, k: int) -> BloomFilter:
    """A filter from its uint32 words (copied)."""
    words = np.array(bits, np.uint32)
    if words.shape != (m_bits // 32,):
        raise ValueError(f"{words.shape[0]} words do not hold {m_bits} bits")
    return BloomFilter(bits=words, m_bits=int(m_bits), k=int(k))


def stream_state_from_host(emu: dict, kind, bank, row, delta, dep,
                           weak=None, device="cpu") -> StreamState:
    """The reference's ``StreamState`` as numpy -> the port's, to hand a
    stream over between windows: ``emu`` is ``ss.emu.to_host()`` (fault
    carry included) and the five trace arrays are the window's, each with
    the leading batch axis the port's carry has (add ``[None]`` to a
    single stream's). The reference probes the Bloom filter at every
    pick, so its state holds no weak flags: ``weak`` (int8 ``[B, L]``,
    the probe of the window's keys) is the port's, None without a
    filter."""
    arrays = dict(zip(TRACE_FIELDS, (kind, bank, row, delta, dep)))
    return StreamState.from_host({"emu": emu, **arrays, "weak": weak},
                                 device)


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (``bfloat16`` from ``ml_dtypes`` included, as
    ``np.asarray`` of a JAX array gives it) -> a tensor on ``device``
    (the CPU unless asked, as ``torch.from_numpy``)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_numpy(tree, device):
    """The reference's LM parameter tree or decode cache (nested dicts,
    numpy leaves with the stacked ``[G, ...]`` layer axis; the cache is
    ``{"p<i>": {...}}``: an attention position's ``"k"`` / ``"v"`` ``[G,
    B, S, KV, hd]``, a mamba position's ``"conv"`` ``[G, B, K-1, di]``
    and ``"h"`` ``[G, B, di, N]``) -> the port's, leaf for leaf, dtype
    kept (a bf16 k / v / conv stays bf16, a float32 ``h`` float32).
    ``device`` is resolved as the entry points resolve it: ``None`` means
    CUDA."""
    dev = resolve_device(device)

    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        return tensor_from_numpy(t, dev)
    return convert(tree)


cache_from_numpy = lm_params_from_numpy


def adamw_state_from_numpy(state, device) -> AdamWState:
    """The reference's ``AdamWState`` with numpy leaves (``tree_map(
    np.asarray, state)``: a 0-d int32 step, the master, m and v trees)
    -> the port's on ``device`` (``None`` means CUDA), dtypes kept."""
    step, master, m, v = state
    return AdamWState(step=tensor_from_numpy(step, resolve_device(device)),
                      master=lm_params_from_numpy(master, device),
                      m=lm_params_from_numpy(m, device),
                      v=lm_params_from_numpy(v, device))
