"""Deterministic DRAM fault injection: retention weak cells and RowHammer.

A :class:`FaultModel` describes the error processes with plain integers
(hashable: it rides ``SystemConfig.faults`` into the engine's group keys).
The processes advance once per served request, inside the slot scan, in
:func:`apply_slot`, which the plain engine (``kernels/ref.py``) calls
batched over trace rows and the CUDA kernel (``csrc/slot_scan.cu``)
repeats per row:

* **RowHammer**: each row activation increments its bank's aggressor
  counter; an all-bank REF resets every counter (before the slot's own
  activation), a fired ``mitigate`` the served bank's. When a counter
  crosses ``hammer_threshold`` on an activation, the two neighbours of
  the activated row each flip with probability ``hammer_flip_fp`` /
  65536, and the counter resets.
* **Retention**: each (bank, row) is weak with probability ``weak_fp`` /
  65536 (a hash, no table); a READ of a weak row flips when its service
  time lies at least ``retention_ticks`` past the last tREFI boundary.

Every draw is a threefry chain (``core.threefry``) of (seed, bank, row,
DRAM time), exactly the reference package's ``jax.random`` chains, so the
flip sets equal the reference's. Flip events go to a bounded victim log
(``victim_slots`` entries of bank, row, tick); the counts go on past it.
``hammer_threshold == 0`` and ``weak_fp == 0`` switch their process off.
The policy VM's ``hammer_ct`` load reads the served bank's counter and
``para_rand`` draws :func:`para_draw` (seed 0 without a fault model).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.dram import READ, at_index, set_index
from repro_torch.core.threefry import bits32, fold_in, prng_key

# fold_in domains: disjoint streams under one seed
DOMAIN_HAMMER = 1
DOMAIN_WEAK = 2
DOMAIN_PARA = 3
# the result fields of a fault model (fault_result_fields)
FAULT_SCALARS = ("flips", "ham_flips", "ret_flips", "mitigations")
FAULT_LOGS = ("victim_bank", "victim_row", "victim_t")

_FP_ONE = 65536  # probability fixed-point denominator (16-bit)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One deterministic DRAM error process. Probabilities are 16-bit
    fixed point: ``x / 65536``. ``hammer_threshold == 0`` disables the
    RowHammer model; ``weak_fp == 0`` disables the retention model."""
    seed: int = 0
    hammer_threshold: int = 0
    hammer_flip_fp: int = _FP_ONE
    weak_fp: int = 0
    retention_ticks: int = 0
    victim_slots: int = 32

    def validate(self) -> "FaultModel":
        if self.hammer_threshold < 0:
            raise ValueError(
                f"hammer_threshold must be >= 0, got {self.hammer_threshold}")
        for nm in ("hammer_flip_fp", "weak_fp"):
            v = getattr(self, nm)
            if not 0 <= v <= _FP_ONE:
                raise ValueError(
                    f"{nm} is 16-bit fixed point in [0, {_FP_ONE}], got {v}")
        if self.retention_ticks < 0:
            raise ValueError(
                f"retention_ticks must be >= 0, got {self.retention_ticks}")
        if self.victim_slots < 1:
            raise ValueError(
                f"victim_slots must be >= 1, got {self.victim_slots}")
        return self


def domain_key(seed: int, domain: int):
    """``fold_in(PRNGKey(seed), domain)``: one stream's key, two words."""
    return fold_in(prng_key(seed), domain)


def init_fault_state(fm: FaultModel, n_banks: int,
                     batch: Optional[int] = None, device=None) -> dict:
    """Fresh fault carry: per-bank aggressor counters, the victim log (-1
    = empty) and the counters; ``batch`` adds a leading axis. ``vptr`` is
    the total flip count (log writes stop at ``victim_slots``)."""
    lead = () if batch is None else (batch,)
    i32 = dict(dtype=torch.int32, device=device)
    V = int(fm.victim_slots)
    return {
        "hct": torch.zeros(lead + (n_banks,), **i32),
        "vbank": torch.full(lead + (V,), -1, **i32),
        "vrow": torch.full(lead + (V,), -1, **i32),
        "vt": torch.full(lead + (V,), -1, **i32),
        "vptr": torch.zeros(lead, **i32),
        "ham_flips": torch.zeros(lead, **i32),
        "ret_flips": torch.zeros(lead, **i32),
        "mitigations": torch.zeros(lead, **i32),
    }


def _words(t: torch.Tensor) -> torch.Tensor:
    """int32 data as int64 (``fold_in`` masks it to its uint32 pattern)."""
    return t.to(torch.int64)


def _u16(key) -> torch.Tensor:
    """The top 16 bits of ``bits32(key)``, int32: ``_u16(k) < fp`` fires
    with probability fp / 65536."""
    return torch.as_tensor(bits32(key) >> 16).to(torch.int32)


def para_bits(kp, q_bank: torch.Tensor, q_row: torch.Tensor,
              now: torch.Tensor) -> torch.Tensor:
    """The ``para_rand`` draws under the PARA stream key ``kp``: lanes
    ``[..., Q]``, ``now`` (the DRAM frontier at the decision) ``[...]``."""
    kt = fold_in(kp, _words(torch.as_tensor(now)).unsqueeze(-1))
    return _u16(fold_in(fold_in(kt, _words(q_bank)), _words(q_row)))


def para_draw(seed: int, q_bank: torch.Tensor, q_row: torch.Tensor,
              now: torch.Tensor) -> torch.Tensor:
    """Per-lane uniform 16-bit draws for the ``para_rand`` load: a hash of
    (seed, bank, row, decision-time DRAM frontier)."""
    return para_bits(domain_key(seed, DOMAIN_PARA), q_bank, q_row, now)


def apply_slot(fm: FaultModel, n_rows: int, tREFI: int, mit_ticks: int,
               fstate: dict, *, do, hit, bank, row, kind, t_start,
               refreshed, mitigate, keys=None):
    """Advance the fault carry of every trace row by one slot.

    ``do`` / ``hit`` are the slot's serve and row-hit flags, ``bank`` /
    ``row`` / ``kind`` the served request, ``t_start`` its DRAM service
    tick, ``refreshed`` whether the service caught up on all-bank REFs,
    ``mitigate`` the policy's flag for the served request (None: no
    policy); all ``[B]``. ``keys`` are the hammer and weak stream keys
    (derived from ``fm.seed`` when None). Returns the new carry and the
    extra ticks of a fired mitigation on the served bank ``[B]``."""
    if keys is None:
        keys = (domain_key(fm.seed, DOMAIN_HAMMER),
                domain_key(fm.seed, DOMAIN_WEAK))
    kh, kw = keys
    mit = torch.zeros_like(do) if mitigate is None else (mitigate & do)
    bank64, row64 = _words(bank), _words(row)

    # an all-bank REF runs before the access: the reset precedes this
    # slot's own activation
    hct = torch.where(refreshed.unsqueeze(1), 0, fstate["hct"])
    events = []   # (flip predicate, victim row, is_hammer)
    if fm.hammer_threshold > 0:
        act = do & ~hit
        old = at_index(hct, bank)
        cur = old + act.to(torch.int32)
        crossed = act & (cur >= fm.hammer_threshold)
        kt = fold_in(fold_in(kh, bank64), _words(t_start))
        for off in (-1, 1):   # the two physical neighbours
            vr = row + off
            valid = (vr >= 0) & (vr < n_rows)
            u = _u16(fold_in(kt, _words(vr)))
            events.append((crossed & valid & (u < fm.hammer_flip_fp), vr,
                           True))
        hct = set_index(hct, bank, torch.where(
            do, torch.where(crossed | mit, 0, cur), old))
    if fm.weak_fp > 0:
        weak = _u16(fold_in(fold_in(kw, bank64), row64)) < fm.weak_fp
        decayed = torch.remainder(t_start, tREFI) >= fm.retention_ticks
        events.append((do & (kind == READ) & weak & decayed, row, False))

    vbank, vrow, vt = fstate["vbank"], fstate["vrow"], fstate["vt"]
    vptr = fstate["vptr"]
    ham = torch.zeros_like(vptr)
    ret = torch.zeros_like(vptr)
    V = int(fm.victim_slots)
    for pred, r, is_ham in events:
        i = vptr.clamp(0, V - 1)
        can = pred & (vptr < V)   # the log is bounded, the counts are not
        vbank = set_index(vbank, i,
                          torch.where(can, bank, at_index(vbank, i)))
        vrow = set_index(vrow, i, torch.where(can, r, at_index(vrow, i)))
        vt = set_index(vt, i, torch.where(can, t_start, at_index(vt, i)))
        vptr = vptr + pred.to(torch.int32)
        if is_ham:
            ham = ham + pred.to(torch.int32)
        else:
            ret = ret + pred.to(torch.int32)

    new = {
        "hct": hct, "vbank": vbank, "vrow": vrow, "vt": vt, "vptr": vptr,
        "ham_flips": fstate["ham_flips"] + ham,
        "ret_flips": fstate["ret_flips"] + ret,
        "mitigations": fstate["mitigations"] + mit.to(torch.int32),
    }
    return new, torch.where(mit, mit_ticks, 0).to(torch.int32)


def fault_result_fields(fstate: dict) -> dict:
    """The result entries of a final fault carry."""
    return {
        "flips": fstate["vptr"],
        "ham_flips": fstate["ham_flips"],
        "ret_flips": fstate["ret_flips"],
        "mitigations": fstate["mitigations"],
        "victim_bank": fstate["vbank"],
        "victim_row": fstate["vrow"],
        "victim_t": fstate["vt"],
    }

