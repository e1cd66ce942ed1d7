"""Policy autotuning: random and evolutionary search over the policy
VM's op space, each generation scored on the runtime policy axis.

Policies are programs, so better ones can be found, not only written. A
population of random :class:`~repro_torch.core.smcprog.PolicyProgram`
candidates (seeded with the built-in schedulers, so the search never
ends below the best known one) evolves by mutation and crossover, and
every generation is scored with one
:func:`repro_torch.core.emulator.run_policies` call: one ``slot_scan``
launch per trace-length bucket, each row running its own program through
the policy VM inside the scan (``csrc/policy_vm.cuh``). Every candidate
is capped at ``max_ops`` <= one table bucket, so a generation is one
group.

Usage::

    from repro_torch.core.policysearch import search

    res = search(trace, JETSON_NANO, generations=8, population=32, seed=0)
    print(res.summary())        # tuned-vs-baseline table
    best = res.best             # a PolicyProgram; run it anywhere

Determinism: the search is a pure function of (trace, sys, mode, seed,
knobs): candidates come from a seeded ``numpy.random.RandomState``, with
the reference's draws in the reference's order (the same seed gives the
same programs), and fitness from the exact engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import emulator, smcprog
from repro_torch.core.smcprog import (OP_CONST, OP_SELECT, PolicyProgram,
                                _BINARY, _UNARY, builtin_programs,
                                table_bucket)

__all__ = ["SearchResult", "random_program", "mutate", "crossover",
           "search"]

# candidate instruction pools: every environment load plus the full ALU.
# hammer_ct / para_rand are deterministic env loads too (seeded in the
# engine), so they stay in the pool: a schedule may use randomized
# tie-breaking.
_LOADS: Tuple[int, ...] = tuple(
    range(smcprog.OP_AGE, smcprog.OP_PARA_RAND + 1))
_ALU: Tuple[int, ...] = tuple(sorted(_BINARY)) + (smcprog.OP_NOT,
                                                  OP_SELECT)
_IMM_LO, _IMM_HI = -8, 65             # const range: small masks/weights


def _random_row(rng: np.random.RandomState, i: int,
                p_load: float = 0.45) -> Tuple[int, int, int, int]:
    """One valid SSA row for table position ``i`` (operands < i)."""
    if i == 0 or rng.random_sample() < p_load:
        if rng.random_sample() < 0.25:
            return (OP_CONST, 0, 0, int(rng.randint(_IMM_LO, _IMM_HI)))
        return (int(_LOADS[rng.randint(len(_LOADS))]), 0, 0, 0)
    op = int(_ALU[rng.randint(len(_ALU))])
    a = int(rng.randint(i))
    b = int(rng.randint(i))
    if op in _UNARY:
        return (op, a, 0, 0)
    if op == OP_SELECT:
        return (op, a, b, int(rng.randint(i)))   # imm is the 3rd operand
    return (op, a, b, 0)


def random_program(rng: np.random.RandomState, max_ops: int = 8,
                   name: str = "rand") -> PolicyProgram:
    """A random valid program of 2..``max_ops`` rows; the last value is
    the score (so every instruction is at least reachable from it)."""
    n = int(rng.randint(2, max_ops + 1))
    rows = tuple(_random_row(rng, i) for i in range(n))
    return PolicyProgram(rows, score_reg=n - 1, name=name).validate()


def mutate(prog: PolicyProgram, rng: np.random.RandomState,
           max_ops: int = 8, name: str = "mut") -> PolicyProgram:
    """One random edit: replace a row, re-pick an operand, retarget the
    score register, perturb a constant, or (under the cap) grow by one
    combining row. Always returns a valid program in the same table
    bucket (``n_ops`` <= ``max_ops``)."""
    rows = [tuple(r) for r in prog.table]
    score = prog.score_reg
    n = len(rows)
    kind = rng.randint(5)
    if kind == 0:                                 # replace one row
        i = int(rng.randint(n))
        rows[i] = _random_row(rng, i)
    elif kind == 1 and n > 1:                     # re-pick an operand
        i = int(rng.randint(1, n))
        op, a, b, imm = rows[i]
        if op in _BINARY or op == OP_SELECT:
            if rng.random_sample() < 0.5:
                a = int(rng.randint(i))
            else:
                b = int(rng.randint(i))
            rows[i] = (op, a, b, imm)
        elif op in _UNARY:
            rows[i] = (op, int(rng.randint(i)), 0, 0)
    elif kind == 2:                               # retarget the score
        score = int(rng.randint(n))
    elif kind == 3:                               # perturb a const
        consts = [i for i, r in enumerate(rows) if r[0] == OP_CONST]
        if consts:
            i = consts[int(rng.randint(len(consts)))]
            op, a, b, imm = rows[i]
            rows[i] = (op, a, b,
                       int(np.clip(imm + rng.randint(-4, 5),
                                   _IMM_LO, _IMM_HI)))
        else:
            i = int(rng.randint(n))
            rows[i] = _random_row(rng, i)
    else:                                         # grow by one row
        if n < max_ops:
            rows.append(_random_row(rng, n, p_load=0.0)
                        if n > 0 else _random_row(rng, 0))
            score = n                             # new row is the score
        else:
            i = int(rng.randint(n))
            rows[i] = _random_row(rng, i)
    return PolicyProgram(tuple(rows), score_reg=score,
                         name=name).validate()


def crossover(a: PolicyProgram, b: PolicyProgram,
              rng: np.random.RandomState,
              name: str = "xover") -> PolicyProgram:
    """Positional splice: the child takes ``a``'s prefix and ``b``'s
    suffix at one cut point. Rows keep their table positions, so SSA
    operand validity (refs < own index) is preserved by construction;
    the child inherits ``b``'s length and score register."""
    cut = int(rng.randint(0, min(a.n_ops, b.n_ops) + 1))
    rows = tuple(a.table[:cut]) + tuple(b.table[cut:])
    return PolicyProgram(rows, score_reg=b.score_reg,
                         name=name).validate()


@dataclasses.dataclass
class SearchResult:
    """Outcome of one :func:`search` run."""
    best: PolicyProgram                  # highest-fitness program found
    best_fitness: float                  # its objective value (lower=better)
    baseline: PolicyProgram              # the named baseline program
    baseline_fitness: float
    objective: str                       # record field minimized
    history: List[dict]                  # per-generation {gen, best, mean}
    n_evaluated: int                     # distinct programs scored
    n_dispatches: int                    # run_policies calls spent
    leaderboard: List[dict]              # top programs vs baseline

    @property
    def improvement(self) -> float:
        """baseline/best objective ratio (>1 means the search won)."""
        return self.baseline_fitness / max(self.best_fitness, 1e-12)

    def summary(self) -> str:
        """Tuned-vs-baseline table, one line per leaderboard entry."""
        lines = [f"objective: {self.objective} (lower is better); "
                 f"baseline {self.baseline.name} = "
                 f"{self.baseline_fitness:.3f}; "
                 f"{self.n_evaluated} programs in "
                 f"{self.n_dispatches} dispatches"]
        for row in self.leaderboard:
            lines.append(
                f"  {row['name']:<16} {row[self.objective]:>10.3f}  "
                f"x{row['vs_baseline']:.4f} vs baseline  "
                f"({row['n_ops']} ops, digest {row['digest']})")
        return "\n".join(lines)


def _seed_population(rng: np.random.RandomState, population: int,
                     max_ops: int, seeds: Sequence[PolicyProgram],
                     baseline: PolicyProgram) -> List[PolicyProgram]:
    pop: List[PolicyProgram] = [baseline]
    pop += [p for p in seeds if p.digest != baseline.digest]
    k = 0
    while len(pop) < population:
        pop.append(random_program(rng, max_ops, name=f"rand{k}"))
        k += 1
    return pop[:population]


def search(trace, sys, mode: str = "ts", *,
           generations: int = 6, population: int = 24,
           max_ops: int = 8, elite: int = 4, seed: int = 0,
           baseline: str = "frfcfs",
           objective: str = "avg_load_latency_cycles",
           seeds: Optional[Sequence[PolicyProgram]] = None,
           derive_cost: bool = False,
           serial: Optional[bool] = None, device=None) -> SearchResult:
    """Evolve scheduling policies for one workload.

    Every generation scores its not-yet-seen candidates with one
    :func:`emulator.run_policies` call (fitness of repeat candidates is
    memoized by content digest). ``max_ops`` <=
    :data:`smcprog.TABLE_BUCKET_FLOOR` keeps the whole search inside one
    table bucket: one ``slot_scan`` group a generation.

    ``seeds`` (default: all built-in schedulers) join generation 0, so
    the result can only improve on the best known hand-written policy;
    ``baseline`` names the program the leaderboard compares against.
    ``derive_cost=False`` (default) scores pure scheduling quality —
    every candidate pays ``sys``'s decision cost; ``True`` charges each
    program its length-derived cost instead. ``serial`` passes to
    :func:`emulator.run_policies`; ``device`` is the engine's (None =
    CUDA).
    """
    if elite < 1 or population < 2:
        raise ValueError(f"need population >= 2 and elite >= 1, got "
                         f"population={population}, elite={elite}")
    if max_ops < 2:
        raise ValueError(f"max_ops must be >= 2, got {max_ops}")
    builtins = builtin_programs()
    if seeds is None:
        seeds = [p for p in builtins.values()
                 if table_bucket(p.n_ops) <= table_bucket(max_ops)]
    if baseline in builtins:
        base_prog = builtins[baseline]
    else:
        by_name = {p.name: p for p in seeds}
        if baseline not in by_name:
            raise ValueError(f"baseline {baseline!r} is neither a "
                             f"built-in nor among seeds "
                             f"{sorted(by_name)}")
        base_prog = by_name[baseline]

    rng = np.random.RandomState(seed)
    pop = _seed_population(rng, population, max_ops, seeds, base_prog)
    scores: Dict[str, float] = {}        # digest -> objective value
    by_digest: Dict[str, PolicyProgram] = {}
    history: List[dict] = []
    n_dispatches = 0

    def fitness(p: PolicyProgram) -> float:
        return scores[p.digest]

    for gen in range(generations):
        todo, seen = [], set()
        for p in pop:
            if p.digest not in scores and p.digest not in seen:
                todo.append(p)
                seen.add(p.digest)
        if todo:
            recs = emulator.run_policies(trace, sys, todo, mode=mode,
                                         derive_cost=derive_cost,
                                         device=device, serial=serial)
            n_dispatches += 1
            for p, r in zip(todo, recs):
                scores[p.digest] = float(r[objective])
                by_digest[p.digest] = p
        pop.sort(key=lambda p: (fitness(p), p.n_ops))
        history.append({
            "gen": gen,
            "best": fitness(pop[0]),
            "mean": float(np.mean([fitness(p) for p in pop])),
            "evaluated": len(scores),
        })
        if gen == generations - 1:
            break
        elites = pop[:elite]
        nxt = list(elites)
        k = 0
        while len(nxt) < population:
            r = rng.random_sample()
            tag = f"g{gen + 1}c{k}"
            if r < 0.55:
                parent = elites[int(rng.randint(len(elites)))]
                nxt.append(mutate(parent, rng, max_ops,
                                  name=f"mut-{tag}"))
            elif r < 0.8 and len(elites) >= 2:
                i, j = rng.choice(len(elites), size=2, replace=False)
                nxt.append(crossover(elites[int(i)], elites[int(j)],
                                     rng, name=f"xo-{tag}"))
            else:
                nxt.append(random_program(rng, max_ops,
                                          name=f"rand-{tag}"))
            k += 1
        pop = nxt

    base_fit = scores[base_prog.digest]
    ranked = sorted(by_digest.values(), key=lambda p: (fitness(p), p.n_ops))
    leaderboard = [{
        "name": p.name, "digest": p.digest, "n_ops": p.n_ops,
        objective: fitness(p),
        "vs_baseline": base_fit / max(fitness(p), 1e-12),
    } for p in ranked[:max(elite, 5)]]
    best = ranked[0]
    return SearchResult(
        best=best, best_fitness=fitness(best),
        baseline=base_prog, baseline_fitness=base_fit,
        objective=objective, history=history,
        n_evaluated=len(scores), n_dispatches=n_dispatches,
        leaderboard=leaderboard)
