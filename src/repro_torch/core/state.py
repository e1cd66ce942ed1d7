"""The emulation engine's carry, :class:`EmulatorState`.

Everything one scheduling slot threads to the next: the DRAM bank state
machine, per-request issue / response tags, the hardware request queue
(request indices, -1 = free), the in-order issue pointer, the two clock
domains (``mc_release`` in modeled proc cycles, ``dram_now`` in DRAM
ticks) and the served / hit / SMC counters. The plain slot-scan engine
(``repro_torch.kernels.ref``) carries one, with a leading batch axis;
the CUDA slot-scan kernel keeps the same fields on chip. ``faults`` is
the fault model's carry (``core.faults.init_fault_state``), empty without
a fault model. :meth:`to_host` / :meth:`from_host` exchange it as nested
numpy dicts in the reference layout.

:class:`StreamState` is one stream window's carry (the reference's
``emulator.StreamState``): the :class:`EmulatorState` of the window plus
its five trace arrays and, with a Bloom filter, the window's weak-row
flags, which shift with the trace.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.dram import NOP, Geometry, init_bank_state
from repro_torch.core.faults import init_fault_state

BIG = 2 ** 30


@dataclasses.dataclass
class EmulatorState:
    bank: dict                 # DRAM bank state (dram.init_bank_state)
    t_issue: torch.Tensor      # int32 [..., N] issue tag per request
    t_resp: torch.Tensor       # int32 [..., N] response tag (BIG = unserved)
    queue: torch.Tensor        # int32 [..., Q] hardware request buffer
    ptr: torch.Tensor          # int32 in-order issue pointer
    mc_release: torch.Tensor   # time-scaling MC counter (proc cycles)
    dram_now: torch.Tensor     # DRAM real-time frontier (ticks)
    hits: torch.Tensor         # row-hit counter
    served_n: torch.Tensor     # serve-slot counter
    smc_fpga_cycles: torch.Tensor
    last_bank: torch.Tensor    # bank of the last served request
    faults: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def fresh(n: int, n_banks: int, q: int, batch: Optional[int] = None,
              device=None) -> "EmulatorState":
        """Fresh state for an n-request trace and a Q-deep queue; ``batch``
        adds a leading axis."""
        lead = () if batch is None else (batch,)
        i32 = dict(dtype=torch.int32, device=device)

        def scalar(v):
            return torch.full(lead, v, **i32)

        return EmulatorState(
            bank=init_bank_state(Geometry(n_banks=n_banks), batch, device),
            t_issue=torch.zeros(lead + (n,), **i32),
            t_resp=torch.full(lead + (n,), BIG, **i32),
            queue=torch.full(lead + (q,), -1, **i32),
            ptr=scalar(0), mc_release=scalar(0), dram_now=scalar(0),
            hits=scalar(0), served_n=scalar(0), smc_fpga_cycles=scalar(0),
            last_bank=scalar(-1))

    @staticmethod
    def init(n: int, sys, batch: Optional[int] = None,
             device=None) -> "EmulatorState":
        """Fresh single-shot state for an n-request trace under ``sys``,
        with the fault carry of ``sys.faults`` (none without one)."""
        st = EmulatorState.fresh(n, sys.geometry.n_banks,
                                 max(sys.window, 2), batch, device)
        if sys.faults is not None:
            st.faults = init_fault_state(sys.faults, sys.geometry.n_banks,
                                         batch, device)
        return st

    def to_host(self) -> dict:
        """Nested dict of numpy arrays (the reference ``to_host`` layout)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = ({k: x.cpu().numpy() for k, x in v.items()}
                           if isinstance(v, dict) else v.cpu().numpy())
        return out

    @staticmethod
    def from_host(d: dict, device=None) -> "EmulatorState":
        """Inverse of :meth:`to_host`; also takes the reference package's
        ``EmulatorState.to_host()`` dict, fault carry included."""
        def tens(x):
            return torch.as_tensor(np.array(x, np.int32), device=device)

        return EmulatorState(**{
            k: ({kk: tens(x) for kk, x in v.items()}
                if isinstance(v, dict) else tens(v))
            for k, v in d.items()})


TRACE_FIELDS = ("kind", "bank", "row", "delta", "dep")


@dataclasses.dataclass
class StreamState:
    """One stream window's carry, with a leading batch axis: the window's
    :class:`EmulatorState` and its trace arrays ``[B, L]`` (the trailing
    halo of which the next window needs), plus the weak-row flags ``[B, L]``
    int8 of a Bloom-filtered group (None without a filter)."""
    emu: EmulatorState
    kind: torch.Tensor
    bank: torch.Tensor
    row: torch.Tensor
    delta: torch.Tensor
    dep: torch.Tensor
    weak: Optional[torch.Tensor] = None

    @staticmethod
    def init(chunk: int, halo: int, sys, batch: int, use_weak: bool = False,
             device=None) -> "StreamState":
        """The window-0 carry (the reference's ``_stream_init``): an
        all-virtual window of L = chunk + halo NOPs with t_issue = 0,
        t_resp = -1 and ``ptr = L``, so that the first shift lands the
        pointer on the first real request, and the frontier's lookback
        terms ``t_resp + 1`` read 0, the single-shot out-of-range
        default. Weak flags start at 0 (the first window probes the
        whole window, virtual halo included)."""
        L = chunk + halo
        emu = EmulatorState.init(L, sys, batch, device)
        emu.t_resp.fill_(-1)
        emu.ptr.fill_(L)
        z = torch.zeros((batch, L), dtype=torch.int32, device=device)
        return StreamState(
            emu=emu, kind=torch.full_like(z, NOP), bank=z, row=z.clone(),
            delta=z.clone(), dep=z.clone(),
            weak=(torch.zeros((batch, L), dtype=torch.int8, device=device)
                  if use_weak else None))

    def to_host(self) -> dict:
        """Nested dict of numpy arrays: ``emu`` in the reference layout,
        the trace arrays, and ``weak`` (None without a filter)."""
        out = {"emu": self.emu.to_host()}
        for f in TRACE_FIELDS:
            out[f] = getattr(self, f).cpu().numpy()
        out["weak"] = None if self.weak is None else self.weak.cpu().numpy()
        return out

    @staticmethod
    def from_host(d: dict, device=None) -> "StreamState":
        """Inverse of :meth:`to_host`."""
        weak = d.get("weak")
        return StreamState(
            emu=EmulatorState.from_host(d["emu"], device),
            **{f: torch.as_tensor(np.array(d[f], np.int32), device=device)
               for f in TRACE_FIELDS},
            weak=None if weak is None else torch.as_tensor(
                np.array(weak, np.int8), device=device))
