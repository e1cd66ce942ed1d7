"""The emulation engine's carry, :class:`EmulatorState`.

Everything one scheduling slot threads to the next: the DRAM bank state
machine, per-request issue / response tags, the hardware request queue
(request indices, -1 = free), the in-order issue pointer, the two clock
domains (``mc_release`` in modeled proc cycles, ``dram_now`` in DRAM
ticks) and the served / hit / SMC counters. The plain slot-scan engine
(``repro_torch.kernels.ref``) carries one, with a leading batch axis;
the CUDA slot-scan kernel keeps the same fields in registers.
:meth:`to_host` / :meth:`from_host` exchange it as nested numpy dicts in
the reference layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.dram import Geometry, init_bank_state

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
        """Fresh single-shot state for an n-request trace under ``sys``."""
        if sys.faults is not None:
            raise NotImplementedError("fault injection: ROADMAP Queue A 7")
        return EmulatorState.fresh(n, sys.geometry.n_banks,
                                   max(sys.window, 2), batch, device)

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
        ``EmulatorState.to_host()`` dict."""
        if d.get("faults"):
            raise NotImplementedError("fault injection: ROADMAP Queue A 7")

        def tens(x):
            return torch.as_tensor(np.array(x, np.int32), device=device)

        kw = {k: ({kk: tens(x) for kk, x in v.items()}
                  if isinstance(v, dict) else tens(v))
              for k, v in d.items() if k != "faults"}
        return EmulatorState(**kw, faults={})
