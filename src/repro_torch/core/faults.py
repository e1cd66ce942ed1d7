"""Deterministic DRAM fault model: the configuration only.

``SystemConfig`` carries a :class:`FaultModel` (hashable, all-integer),
so the dataclass and its validation live here. The error processes
themselves (RowHammer and retention flips drawn from threefry chains)
are not ported yet: the engine raises ``NotImplementedError`` when a
config carries a fault model (ROADMAP Queue A 7).
"""
from __future__ import annotations

import dataclasses

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
