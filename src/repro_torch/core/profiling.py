"""Seeded DRAM device model (the 'real chip' the FPGA platform talks to).

There is no silicon here, so per-cell behavior comes from a deterministic
statistical model calibrated to the paper's reported aggregates:

* Fig. 12 — every row works below nominal tRCD (13.5 ns); 84.5% of cache
  lines are *strong* (reliable at <= 9.0 ns); weak lines cluster spatially
  (bank regions). We model a per-row minimum reliable tRCD as
  base + bank effect + smooth region effect + row noise.
* RowClone (Sec. 7) — FPM copy only works intra-subarray, and a few
  (src, dst) pairs fail chip-specifically; the allocator discovers this by
  profiling (1000-op test in the paper; a deterministic hash here).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dram import Geometry


class DeviceModel:
    def __init__(self, geo: Geometry, seed: int = 7, weak_target: float = 0.155,
                 clone_fail_rate: float = 0.02):
        self.geo = geo
        self.seed = seed
        rng = np.random.RandomState(seed)
        nb, nr = geo.n_banks, geo.n_rows
        region = geo.subarray_rows
        n_regions = nr // region
        # spatially clustered weakness: per-(bank, region) offset, smoothed
        bank_eff = rng.normal(0.0, 0.6, size=(nb, 1))
        reg = rng.normal(0.0, 1.0, size=(nb, n_regions))
        kern = np.array([0.25, 0.5, 1.0, 0.5, 0.25])
        reg = np.apply_along_axis(lambda v: np.convolve(v, kern, mode="same"), 1, reg)
        reg_eff = np.repeat(reg, region, axis=1)
        noise = rng.normal(0.0, 0.35, size=(nb, nr))
        score = bank_eff + reg_eff + noise
        # calibrate threshold so P(weak) == weak_target
        thr = np.quantile(score, 1.0 - weak_target)
        self.weak = score > thr                       # [banks, rows] bool
        # min reliable tRCD in ns: strong in [6, 9], weak in (9, 13.2]
        u = rng.uniform(size=(nb, nr))
        self.min_trcd_ns = np.where(self.weak, 9.2 + 4.0 * u, 6.0 + 3.0 * u)
        self._clone_fail_rate = clone_fail_rate

    def weak_fraction(self) -> float:
        return float(self.weak.mean())

    def weak_rows(self):
        """Global row ids (bank * n_rows + row) of weak rows."""
        b, r = np.nonzero(self.weak)
        return (b.astype(np.int64) * self.geo.n_rows + r).astype(np.int64)

    # ---- RowClone pair characterization ----
    def same_subarray(self, src_row, dst_row) -> bool:
        sa = self.geo.subarray_rows
        return (src_row // sa) == (dst_row // sa)

    def clonable(self, bank: int, src_row: int, dst_row: int) -> bool:
        """Deterministic 'profiled with 1000 copy ops' result."""
        if src_row == dst_row or not self.same_subarray(src_row, dst_row):
            return False
        h = 0x9E3779B97F4A7C15
        mask = (1 << 64) - 1
        x = (bank * 1000003) ^ (src_row * 8191) ^ (dst_row * 131071) ^ self.seed
        x = (x * h) & mask
        x ^= x >> 29
        x = (x * h) & mask
        x ^= x >> 32
        frac = x / float(2 ** 64)
        return frac >= self._clone_fail_rate

    def trcd_heatmap(self, banks=2, rows=4096):
        """Fig.12-style heatmap data: min reliable tRCD (ns)."""
        return self.min_trcd_ns[:banks, :rows]
