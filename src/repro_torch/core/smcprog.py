"""Software-defined SMC scheduling policies: a branchless MC-policy VM.

A scheduling policy is a tiny program over a fixed register IR, authored
with :class:`PolicyBuilder`, assembled into a dense int32 SSA table
(:class:`PolicyProgram`, hashed and compared by table content) and
packed (:func:`pack_program`) into a ``[bucket + 1, 4]`` int32 array
whose row 0 is the header ``(n_ops, score_reg, boost_reg,
mitigate_reg)``. The emulator interprets the packed table on every
scheduling decision; the same interpreter is the ``policy_vm`` kernel
(``repro_torch.kernels``), whose plain version is :func:`eval_table_rows`
here.

A program produces a per-slot ``score`` (int32, lower = served first)
and an optional ``boost`` mask (nonzero = preferred class). Selection is
a two-level argmin: the lowest score among boosted visible slots if any,
else among all visible slots. All arithmetic wraps in int32.

Cost model: ``smc_cycles() = base_cycles + cycles_per_op * len`` (or
``smc_cycles_override``). ``SystemConfig.with_policy(prog)`` folds it
into ``smc_cycles_per_decision``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

BIG = 2 ** 30

# Opcodes. Loads read one named input vector of the scheduling
# environment (length Q, int32); ALU ops combine earlier values.
OP_CONST = 0
OP_AGE = 1
OP_AGE_REL = 2
OP_ROW_HIT = 3
OP_BANK = 4
OP_ROW = 5
OP_IS_WRITE = 6
OP_BANK_BUSY = 7
OP_RR_DIST = 8
OP_QSLOT = 9
OP_WRITE_PRESSURE = 10
OP_HAMMER_CT = 11
OP_PARA_RAND = 12
OP_ADD = 16
OP_SUB = 17
OP_MUL = 18
OP_MIN = 19
OP_MAX = 20
OP_AND = 21
OP_OR = 22
OP_NOT = 23
OP_EQ = 24
OP_LT = 25
OP_GE = 26
OP_SELECT = 27

_LOAD_NAMES = {
    OP_AGE: "age", OP_AGE_REL: "age_rel", OP_ROW_HIT: "row_hit",
    OP_BANK: "bank", OP_ROW: "row", OP_IS_WRITE: "is_write",
    OP_BANK_BUSY: "bank_busy", OP_RR_DIST: "rr_dist", OP_QSLOT: "qslot",
    OP_WRITE_PRESSURE: "write_pressure",
    OP_HAMMER_CT: "hammer_ct", OP_PARA_RAND: "para_rand",
}
_OP_NAMES = {v: k for k, v in globals().items() if k.startswith("OP_")}
_UNARY = {OP_NOT}
_BINARY = {OP_ADD, OP_SUB, OP_MUL, OP_MIN, OP_MAX, OP_AND, OP_OR,
           OP_EQ, OP_LT, OP_GE}
_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Reg:
    """Handle to one SSA value of one builder. Opaque to callers."""
    idx: int
    owner: int = dataclasses.field(repr=False, compare=False, default=0)


@dataclasses.dataclass(frozen=True)
class PolicyProgram:
    """An assembled policy: a dense int32 instruction table in SSA form.

    ``table`` rows are ``(opcode, a, b, imm)``; row *i* defines value
    *i*. ``score_reg`` / ``boost_reg`` / ``mitigate_reg`` name the output
    values (-1 = absent). Equality and hashing are by semantic content;
    ``name`` and the cost-model fields are excluded."""
    table: Tuple[Tuple[int, int, int, int], ...]
    score_reg: int
    boost_reg: int = -1
    mitigate_reg: int = -1
    base_cycles: int = dataclasses.field(default=300, compare=False)
    cycles_per_op: int = dataclasses.field(default=25, compare=False)
    smc_cycles_override: Optional[int] = dataclasses.field(
        default=None, compare=False)
    name: str = dataclasses.field(default="policy", compare=False)

    @property
    def n_ops(self) -> int:
        return len(self.table)

    def smc_cycles(self) -> int:
        """SMC cycles per scheduling decision (length cost model)."""
        if self.smc_cycles_override is not None:
            return int(self.smc_cycles_override)
        return int(self.base_cycles + self.cycles_per_op * self.n_ops)

    @property
    def digest(self) -> str:
        """Content digest (table + outputs); mitigate_reg joins only when
        set, so programs without it keep their digest."""
        sem = (self.table, self.score_reg, self.boost_reg)
        if self.mitigate_reg >= 0:
            sem = sem + (self.mitigate_reg,)
        return hashlib.sha1(repr(sem).encode()).hexdigest()[:12]

    def uses(self, opcode: int) -> bool:
        return any(row[0] == opcode for row in self.table)

    def validate(self) -> "PolicyProgram":
        """Structural check; errors name the row index and op."""
        n = len(self.table)
        if not 0 <= self.score_reg < n:
            raise ValueError(f"score_reg {self.score_reg} out of range "
                             f"for a {n}-row table")
        if not -1 <= self.boost_reg < n:
            raise ValueError(f"boost_reg {self.boost_reg} out of range "
                             f"for a {n}-row table")
        if not -1 <= self.mitigate_reg < n:
            raise ValueError(f"mitigate_reg {self.mitigate_reg} out of "
                             f"range for a {n}-row table")
        for i, (op, a, b, imm) in enumerate(self.table):
            nm = _OP_NAMES.get(op, f"op{op}").lower()
            if op != OP_CONST and op not in _LOAD_NAMES \
                    and op not in _UNARY and op not in _BINARY \
                    and op != OP_SELECT:
                raise ValueError(f"row {i}: unknown opcode {op}")
            refs = (() if op == OP_CONST or op in _LOAD_NAMES
                    else (a,) if op in _UNARY
                    else (a, b) if op in _BINARY else (a, b, imm))
            for r in refs:
                if not 0 <= r < i:
                    raise ValueError(
                        f"row {i} ({nm}): operand {r} is not an earlier "
                        f"value")
            if op == OP_CONST and not _INT32_MIN <= imm <= _INT32_MAX:
                raise ValueError(f"row {i} ({nm}): imm {imm} not int32")
        return self

    def describe(self) -> str:
        """Human-readable disassembly (one line per instruction)."""
        lines = [f"{self.name}: {self.n_ops} ops, "
                 f"{self.smc_cycles()} smc-cycles/decision, "
                 f"digest {self.digest}"]
        for i, (op, a, b, imm) in enumerate(self.table):
            nm = _OP_NAMES.get(op, f"op{op}").lower()[3:]
            if op == OP_CONST:
                arg = str(imm)
            elif op in _LOAD_NAMES:
                arg = ""
            elif op in _UNARY:
                arg = f"v{a}"
            elif op == OP_SELECT:
                arg = f"v{a} ? v{b} : v{imm}"
            else:
                arg = f"v{a}, v{b}"
            out = [tag for tag, reg in (("score", self.score_reg),
                                        ("boost", self.boost_reg),
                                        ("mitigate", self.mitigate_reg))
                   if i == reg]
            tag = ("   -> " + "+".join(out)) if out else ""
            arg = f" {arg}" if arg else ""
            lines.append(f"  v{i} = {nm}{arg}{tag}")
        return "\n".join(lines)


class PolicyBuilder:
    """Author a :class:`PolicyProgram` op by op (SSA; each method
    returns a :class:`Reg` naming its result)."""

    def __init__(self) -> None:
        self._rows: list = []

    def _emit(self, op: int, a: int = 0, b: int = 0, imm: int = 0) -> Reg:
        self._rows.append((op, a, b, imm))
        return Reg(len(self._rows) - 1, id(self))

    def _r(self, reg: Reg) -> int:
        if not isinstance(reg, Reg) or reg.owner != id(self):
            raise ValueError(f"{reg!r} is not a register of this builder")
        return reg.idx

    # ---- environment loads ----
    def score_age(self) -> Reg:
        return self._emit(OP_AGE)

    def age_rel(self) -> Reg:
        return self._emit(OP_AGE_REL)

    def score_row_hit(self) -> Reg:
        return self._emit(OP_ROW_HIT)

    def bank(self) -> Reg:
        return self._emit(OP_BANK)

    def row(self) -> Reg:
        return self._emit(OP_ROW)

    def is_write(self) -> Reg:
        return self._emit(OP_IS_WRITE)

    def mask_bank_busy(self) -> Reg:
        return self._emit(OP_BANK_BUSY)

    def rr_distance(self) -> Reg:
        return self._emit(OP_RR_DIST)

    def qslot(self) -> Reg:
        return self._emit(OP_QSLOT)

    def write_pressure(self) -> Reg:
        return self._emit(OP_WRITE_PRESSURE)

    def hammer_count(self) -> Reg:
        return self._emit(OP_HAMMER_CT)

    def para_rand(self) -> Reg:
        return self._emit(OP_PARA_RAND)

    def prefer_writes_drain(self, threshold: int = 2) -> Reg:
        """1 on write requests while >= ``threshold`` writes are visible."""
        wp = self.write_pressure()
        thr = self.const(threshold)
        drain = self.ge(wp, thr)
        return self.and_(self.is_write(), drain)

    # ---- ALU ----
    def const(self, value: int) -> Reg:
        return self._emit(OP_CONST, imm=int(value))

    def add(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_ADD, self._r(a), self._r(b))

    def sub(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_SUB, self._r(a), self._r(b))

    def mul(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_MUL, self._r(a), self._r(b))

    def min_(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_MIN, self._r(a), self._r(b))

    def max_(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_MAX, self._r(a), self._r(b))

    def and_(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_AND, self._r(a), self._r(b))

    def or_(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_OR, self._r(a), self._r(b))

    def not_(self, a: Reg) -> Reg:
        return self._emit(OP_NOT, self._r(a))

    def eq(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_EQ, self._r(a), self._r(b))

    def lt(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_LT, self._r(a), self._r(b))

    def ge(self, a: Reg, b: Reg) -> Reg:
        return self._emit(OP_GE, self._r(a), self._r(b))

    def select(self, cond: Reg, a: Reg, b: Reg) -> Reg:
        """``cond != 0 ? a : b`` elementwise."""
        return self._emit(OP_SELECT, self._r(cond), self._r(a),
                          imm=self._r(b))

    def build(self, score: Reg, boost: Optional[Reg] = None,
              mitigate: Optional[Reg] = None,
              name: str = "policy", base_cycles: int = 300,
              cycles_per_op: int = 25,
              smc_cycles: Optional[int] = None) -> PolicyProgram:
        return PolicyProgram(
            table=tuple(self._rows), score_reg=self._r(score),
            boost_reg=-1 if boost is None else self._r(boost),
            mitigate_reg=-1 if mitigate is None else self._r(mitigate),
            base_cycles=base_cycles, cycles_per_op=cycles_per_op,
            smc_cycles_override=smc_cycles, name=name).validate()


# ---------------------------------------------------------------------------
# Packed runtime form and the table-driven VM.
# ---------------------------------------------------------------------------

TABLE_BUCKET_FLOOR = 8
_ENV_ORDER = tuple(_LOAD_NAMES[op] for op in range(OP_AGE, OP_PARA_RAND + 1))
N_LOADS = len(_ENV_ORDER)


def table_bucket(n_ops: int) -> int:
    """Padded table length: next power of two, floored at 8."""
    if n_ops < 1:
        raise ValueError(f"n_ops must be >= 1, got {n_ops}")
    b = TABLE_BUCKET_FLOOR
    while b < n_ops:
        b *= 2
    return b


def pack_program(prog: PolicyProgram,
                 bucket: Optional[int] = None) -> np.ndarray:
    """int32 ``[bucket + 1, 4]``: header row then the table padded with
    ``(OP_CONST, 0, 0, 0)`` rows."""
    prog.validate()
    lb = table_bucket(prog.n_ops) if bucket is None else int(bucket)
    if prog.n_ops > lb:
        raise ValueError(
            f"program {prog.name!r} has {prog.n_ops} ops; bucket {lb} "
            f"is too small (needs {table_bucket(prog.n_ops)})")
    out = np.zeros((lb + 1, 4), np.int32)
    out[0] = (prog.n_ops, prog.score_reg, prog.boost_reg,
              prog.mitigate_reg)
    for i, row in enumerate(prog.table):
        out[i + 1] = row
    return out


def pack_stack(progs: Sequence[PolicyProgram],
               bucket: Optional[int] = None) -> np.ndarray:
    """``[P, bucket + 1, 4]`` int32; bucket defaults to the max bucket."""
    if not progs:
        raise ValueError("pack_stack needs at least one program")
    lb = (max(table_bucket(p.n_ops) for p in progs)
          if bucket is None else int(bucket))
    return np.stack([pack_program(p, lb) for p in progs])


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def eval_table_rows(rows: torch.Tensor, envm: torch.Tensor) -> torch.Tensor:
    """The table-driven VM: interpret ``rows`` (``[..., L, 4]`` int32)
    over ``envm`` (``[..., N_LOADS, Q]`` int32, broadcast against the
    leading axes of ``rows``) and return every SSA value, ``[..., L, Q]``
    int32. Every row computes every opcode's candidate and selects by
    opcode; operands are clipped to the table and read zeros from rows
    not yet written; ADD/SUB/MUL wrap in int32."""
    L = rows.shape[-2]
    q = envm.shape[-1]
    lead = torch.broadcast_shapes(rows.shape[:-2], envm.shape[:-2])
    rows = rows.expand(lead + rows.shape[-2:])
    envm = envm.expand(lead + envm.shape[-2:])
    vals = torch.zeros(lead + (L, q), dtype=torch.int32, device=rows.device)

    def row_of(x, idx):  # x[..., idx, :] with idx [...] -> [..., q]
        i = idx.long().reshape(lead + (1, 1)).expand(lead + (1, q))
        return torch.gather(x, -2, i).squeeze(-2)

    for i in range(L):
        op = rows[..., i, 0].unsqueeze(-1)
        imm = rows[..., i, 3]
        va = row_of(vals, rows[..., i, 1].clamp(0, L - 1))
        vb = row_of(vals, rows[..., i, 2].clamp(0, L - 1))
        vc = row_of(vals, imm.clamp(0, L - 1))
        v = imm.unsqueeze(-1).expand(lead + (q,))
        is_load = (op >= OP_AGE) & (op <= OP_PARA_RAND)
        env_v = row_of(envm, (rows[..., i, 0] - OP_AGE).clamp(0, N_LOADS - 1))
        v = torch.where(is_load, env_v, v)
        a64, b64 = va.long(), vb.long()
        for code, cand in (
                (OP_ADD, lambda: wrap32(a64 + b64)),
                (OP_SUB, lambda: wrap32(a64 - b64)),
                (OP_MUL, lambda: wrap32(a64 * b64)),
                (OP_MIN, lambda: torch.minimum(va, vb)),
                (OP_MAX, lambda: torch.maximum(va, vb)),
                (OP_AND, lambda: va & vb),
                (OP_OR, lambda: va | vb),
                (OP_NOT, lambda: (va == 0).int()),
                (OP_EQ, lambda: (va == vb).int()),
                (OP_LT, lambda: (va < vb).int()),
                (OP_GE, lambda: (va >= vb).int()),
                (OP_SELECT, lambda: torch.where(va != 0, vb, vc)),
        ):
            v = torch.where(op == code, cand(), v)
        vals[..., i, :] = v
    return vals


def evaluate_table(tables: torch.Tensor, envm: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., L + 1, 4]`` tables over ``[..., N_LOADS, Q]``
    environments -> ``[..., 3, Q]`` int32 (score, boost, mitigate); an
    absent boost or mitigate register reads as zeros."""
    hdr = tables[..., 0, :]
    vals = eval_table_rows(tables[..., 1:, :], envm)
    lb = vals.shape[-2]
    q = vals.shape[-1]
    lead = vals.shape[:-2]

    def value(reg):
        i = reg.clamp(0, lb - 1).long().reshape(lead + (1, 1))
        return torch.gather(vals, -2, i.expand(lead + (1, q))).squeeze(-2)

    def optional(reg):
        v = value(reg)
        return torch.where(reg.reshape(lead + (1,)) >= 0, v,
                           torch.zeros_like(v))

    hdr = hdr.expand(lead + (4,))
    return torch.stack([value(hdr[..., 1]), optional(hdr[..., 2]),
                        optional(hdr[..., 3])], dim=-2)


def select_slot_table(score: torch.Tensor, boost: torch.Tensor,
                      visible: torch.Tensor) -> torch.Tensor:
    """Two-level argmin over ``[..., Q]`` lanes: clamp scores to
    ``BIG - 1``, the lowest boosted visible lane if any, else the lowest
    visible lane; ties go to the first lane."""
    score = torch.clamp(score, max=BIG - 1)
    big = torch.full_like(score, BIG)
    key_all = torch.where(visible, score, big)
    boost_on = visible & (boost != 0)
    key_boost = torch.where(boost_on, score, big)
    slot_boost = torch.argmin(key_boost, dim=-1)
    slot_all = torch.argmin(key_all, dim=-1)
    return torch.where(boost_on.any(-1), slot_boost, slot_all)


# ---------------------------------------------------------------------------
# Built-in programs.
# ---------------------------------------------------------------------------


def frfcfs_program() -> PolicyProgram:
    """FR-FCFS: oldest-first, row hits first (== legacy 'frfcfs')."""
    b = PolicyBuilder()
    return b.build(score=b.score_age(), boost=b.score_row_hit(),
                   name="frfcfs")


def fcfs_program() -> PolicyProgram:
    """FCFS: strictly oldest-first (== legacy 'fcfs')."""
    b = PolicyBuilder()
    return b.build(score=b.score_age(), name="fcfs")


def bank_round_robin_program() -> PolicyProgram:
    """Cycle banks after the last served bank; relative age breaks ties."""
    b = PolicyBuilder()
    rr = b.rr_distance()
    age = b.min_(b.age_rel(), b.const((1 << 20) - 1))
    score = b.add(b.mul(rr, b.const(1 << 20)), age)
    return b.build(score=score, name="bank-rr")


def open_page_program() -> PolicyProgram:
    """Boost row hits only on banks that are already idle."""
    b = PolicyBuilder()
    hit_idle = b.and_(b.score_row_hit(), b.not_(b.mask_bank_busy()))
    return b.build(score=b.score_age(), boost=hit_idle, name="open-page")


def closed_page_program() -> PolicyProgram:
    """Boost row misses (drain conflicts early)."""
    b = PolicyBuilder()
    return b.build(score=b.score_age(), boost=b.not_(b.score_row_hit()),
                   name="closed-page")


def write_drain_program(threshold: int = 2) -> PolicyProgram:
    """Age-ordered; writes first once ``threshold`` writes are visible."""
    b = PolicyBuilder()
    return b.build(score=b.score_age(),
                   boost=b.prefer_writes_drain(threshold),
                   name=f"write-drain{threshold}")


def builtin_programs() -> Dict[str, PolicyProgram]:
    """All built-ins keyed by name — the default policy-sweep grid."""
    progs = [frfcfs_program(), fcfs_program(), bank_round_robin_program(),
             open_page_program(), closed_page_program(),
             write_drain_program()]
    return {p.name: p for p in progs}


def para_program(p_fp: int = 655) -> PolicyProgram:
    """PARA: on a served row miss, refresh neighbors with prob p_fp/65536."""
    if not 0 <= p_fp <= 65536:
        raise ValueError(f"p_fp is 16-bit fixed point, got {p_fp}")
    b = PolicyBuilder()
    hit = b.score_row_hit()
    coin = b.lt(b.para_rand(), b.const(p_fp))
    return b.build(score=b.score_age(), boost=hit,
                   mitigate=b.and_(coin, b.not_(hit)),
                   name=f"para{p_fp}")


def trr_program(trr_threshold: int = 512) -> PolicyProgram:
    """Counter-based TRR: refresh neighbors at ``trr_threshold`` ACTs."""
    if trr_threshold < 1:
        raise ValueError(f"trr_threshold must be >= 1, got {trr_threshold}")
    b = PolicyBuilder()
    return b.build(score=b.score_age(), boost=b.score_row_hit(),
                   mitigate=b.ge(b.hammer_count(), b.const(trr_threshold)),
                   name=f"trr{trr_threshold}")


def mitigation_programs(para_fp: int = 655,
                        trr_threshold: int = 512) -> Dict[str, PolicyProgram]:
    """Unmitigated FR-FCFS baseline + PARA + counter-based TRR."""
    progs = [frfcfs_program(), para_program(para_fp),
             trr_program(trr_threshold)]
    return {p.name: p for p in progs}
