"""Time scaling: emulation domains, counters, and system configuration.

The modeled system is split into emulation domains — processor(s),
software memory controller (SMC), DRAM — each with a cycle counter. The
engine clock-gates the processor domain while the SMC decides and
releases it by advancing the MC counter with the *emulated-system*
service time. ``SystemConfig`` carries both the modeled system's clocks
and the FPGA platform's clocks, so one engine expresses three modes:

* ``ts``        — time scaling on: emulated time uses f_proc_emu and the
                  modeled HW-MC latency; SMC slowness is invisible.
* ``nots``      — the processor free-runs at f_proc_fpga in FPGA-real
                  time, so SMC slowness and the clock ratio leak in.
* ``reference`` — a hardware MC at the modeled clock; must equal ``ts``.

Every derived property is a host Python number, computed exactly as the
engine's integer arithmetic needs it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.dram import TCK_NS, Geometry, Timing
from repro_torch.core.faults import FaultModel
from repro_torch.core.smcprog import PolicyProgram


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    # modeled (emulated) system — defaults mirror the Jetson Nano / A57
    f_proc_emu_ghz: float = 1.43
    hwmc_latency_ns: float = 20.0
    hwmc_issue_ns: float = 2.0
    # FPGA platform
    f_proc_fpga_mhz: float = 50.0
    f_mc_fpga_mhz: float = 100.0
    smc_cycles_per_decision: int = 400
    smc_transfer_cycles: int = 120
    # processor model
    window: int = 4                     # max outstanding requests (MLP)
    timing: Timing = dataclasses.field(default_factory=Timing)
    geometry: Geometry = dataclasses.field(default_factory=Geometry)
    scheduler: str = "frfcfs"           # frfcfs | fcfs (legacy flag)
    # a staged scheduling program; replaces `scheduler` when set
    policy: Optional[PolicyProgram] = None
    # a fault model (the engine does not run faults yet)
    faults: Optional[FaultModel] = None

    @property
    def proc_per_tick_emu(self) -> float:
        return self.f_proc_emu_ghz * TCK_NS

    @property
    def proc_per_tick_fpga(self) -> float:
        return self.f_proc_fpga_mhz * 1e-3 * TCK_NS

    @property
    def hwmc_latency_proc(self) -> int:
        return int(round(self.hwmc_latency_ns * self.f_proc_emu_ghz))

    @property
    def hwmc_issue_proc(self) -> int:
        return max(int(round(self.hwmc_issue_ns * self.f_proc_emu_ghz)), 1)

    @property
    def smc_latency_fpga_proc(self) -> int:
        """SMC decision latency as seen by a free-running FPGA processor."""
        fpga_ns = (self.smc_cycles_per_decision + self.smc_transfer_cycles) \
            / (self.f_mc_fpga_mhz * 1e-3)
        return int(round(fpga_ns * self.f_proc_fpga_mhz * 1e-3))

    def with_policy(self, prog: PolicyProgram) -> "SystemConfig":
        """Attach a program and derive the decision cost from its length."""
        return dataclasses.replace(self, policy=prog,
                                   smc_cycles_per_decision=prog.smc_cycles())

    def with_faults(self, fm: Optional[FaultModel]) -> "SystemConfig":
        """Attach (or clear, with None) a fault model."""
        return dataclasses.replace(
            self, faults=fm.validate() if fm is not None else None)

    def dram_ticks_to_proc(self, ticks, mode: str):
        if mode == "nots":
            return ticks * self.proc_per_tick_fpga
        return ticks * self.proc_per_tick_emu

    def cycles_to_seconds(self, cycles, mode: str) -> float:
        hz = (self.f_proc_fpga_mhz * 1e6) if mode == "nots" \
            else (self.f_proc_emu_ghz * 1e9)
        return float(cycles) / hz


JETSON_NANO = SystemConfig()

# PiDRAM-style platform: 50 MHz in-order core + RTL memory controller
PIDRAM_LIKE = SystemConfig(f_proc_fpga_mhz=50.0, window=1,
                           smc_cycles_per_decision=0, smc_transfer_cycles=0)

VALIDATION_1GHZ = SystemConfig(f_proc_emu_ghz=1.0, f_proc_fpga_mhz=100.0,
                               f_mc_fpga_mhz=100.0)
