"""DRAM geometry + timing model (DDR4-flavored), all times in DRAM ticks.

One tick = one DRAM command-clock cycle (0.833 ns at DDR4-2400). Every
time is an int32 tick count, so the emulator is exact (no float drift).

:func:`service_request` is the per-bank timing state machine: the exact
DRAM time to serve one request given the current bank state, honoring
tRCD/tRP/tRAS/tCL/tWR/tBL + refresh, with technique hooks (reduced tRCD,
RowClone sequences). Here it works on a leading batch axis: every field
of the bank state carries ``[..., n_banks]`` (or ``[...]`` for the
channel scalars), and ``kind`` / ``bank`` / ``row`` / ``now`` /
``trcd_eff`` are ``[...]`` tensors, one request per batch row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

TCK_NS = 0.833  # DDR4-2400


@dataclasses.dataclass(frozen=True)
class Timing:
    tRCD: int = 17          # 13.5 ns nominal (paper's module, Micron EDY4016A)
    tRCD_reduced: int = 11  # 9.0 ns — strong-row access (Solar-DRAM style)
    tCL: int = 17
    tRP: int = 17
    tRAS: int = 39
    tWR: int = 18
    tBL: int = 4            # burst 8, DDR
    tRTP: int = 9
    tRFC: int = 420         # 350 ns
    tREFI: int = 9360       # 7.8 us
    tRC_CLONE: int = 90     # ACT->PRE->ACT RowClone FPM sequence (~75 ns)

    def as_array(self, device=None) -> torch.Tensor:
        return torch.tensor([self.tRCD, self.tRCD_reduced, self.tCL, self.tRP,
                             self.tRAS, self.tWR, self.tBL, self.tRTP,
                             self.tRFC, self.tREFI, self.tRC_CLONE],
                            dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Geometry:
    n_banks: int = 16       # 4 bankgroups x 4 banks
    n_rows: int = 32768     # per bank (paper cfg: 32K rows)
    row_bytes: int = 8192   # 8 KiB row
    line_bytes: int = 64
    subarray_rows: int = 512

    @property
    def lines_per_row(self) -> int:
        return self.row_bytes // self.line_bytes


# request kinds in traces
READ, WRITE, RC_COPY, RC_INIT, NOP = 0, 1, 2, 3, 4


def neighbor_refresh_ticks(t: Timing) -> int:
    """Cost of one targeted neighbor-row refresh (the RowHammer
    mitigation primitive): an extra ACT+PRE row cycle on the bank."""
    return t.tRAS + t.tRP


def init_bank_state(geo: Geometry, batch: Optional[int] = None,
                    device=None) -> dict:
    """Fresh bank state; ``batch`` adds a leading axis of that size."""
    lead = () if batch is None else (batch,)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "open_row": torch.full(lead + (geo.n_banks,), -1, **i32),
        "ready": torch.zeros(lead + (geo.n_banks,), **i32),   # bank usable
        "act_at": torch.zeros(lead + (geo.n_banks,), **i32),  # last ACT tick
        "bus_busy": torch.zeros(lead, **i32),                 # data bus
        "refs_done": torch.zeros(lead, **i32),
    }


def at_index(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per batch row (idx: x's shape minus the last axis)."""
    return torch.gather(x, -1, idx.long().unsqueeze(-1)).squeeze(-1)


def _set(x: torch.Tensor, idx: torch.Tensor,
         val: torch.Tensor) -> torch.Tensor:
    """Copy of ``x`` with ``x[..., idx] = val`` per batch row."""
    return x.scatter(-1, idx.long().unsqueeze(-1),
                     val.to(x.dtype).unsqueeze(-1))


def service_request(bank_state: dict, t: Timing, kind, bank, row, now,
                    trcd_eff):
    """Serve one request per batch row starting no earlier than ``now``.

    Banks pipeline: a request occupies its *bank* for the row-cycle work
    and the shared channel *bus* for tBL around the data burst.
    ``trcd_eff``: tRCD ticks to use for the activate (technique hook).
    Returns ``(new_bank_state, t_done, row_hit)``; pure function."""
    open_row = at_index(bank_state["open_row"], bank)
    ready = at_index(bank_state["ready"], bank)
    act_at = at_index(bank_state["act_at"], bank)

    # refresh: catch up on REF debt before serving (simplified all-bank REF)
    refs_due = torch.div(now, t.tREFI, rounding_mode="floor") \
        - bank_state["refs_done"]
    refs_due = torch.clamp(refs_due, min=0)
    ref_pen = refs_due * t.tRFC

    start = torch.maximum(now, ready) + ref_pen
    is_rc = (kind == RC_COPY) | (kind == RC_INIT)
    is_hit = (open_row == row) & ~is_rc
    is_closed = open_row < 0

    # PRE (row conflict) must respect tRAS from last ACT
    pre_at = torch.maximum(start, act_at + t.tRAS)
    t_after_pre = pre_at + t.tRP
    act_start = torch.where(is_closed, start, t_after_pre)

    # column access: CAS may issue once the row is open; data needs the bus
    t_act_done = act_start + trcd_eff
    col_start = torch.where(is_hit, start, t_act_done)
    data_start = torch.maximum(col_start + t.tCL, bank_state["bus_busy"])
    data_done = data_start + t.tBL

    # RowClone: ACT(src)-PRE-ACT(dst) fused sequence, no bus traffic
    rc_done = act_start + t.tRC_CLONE
    t_done = torch.where(is_rc, rc_done, data_done)

    # bank stays busy past the burst for writes (tWR write recovery)
    bank_next = torch.where(is_rc, rc_done,
                            torch.where(kind == WRITE, data_done + t.tWR,
                                        data_done))
    new_act_at = torch.where(is_hit, act_at, act_start)

    row_t = torch.as_tensor(row, dtype=torch.int32,
                            device=open_row.device).expand_as(open_row)
    bs = {
        "open_row": _set(bank_state["open_row"], bank, row_t),
        "ready": _set(bank_state["ready"], bank, bank_next),
        "act_at": _set(bank_state["act_at"], bank, new_act_at),
        "bus_busy": torch.where(is_rc, bank_state["bus_busy"], data_done),
        "refs_done": bank_state["refs_done"] + refs_due,
    }
    return bs, t_done, is_hit
