"""Communication verifier: prove the distributed layer's collective bytes,
ring schedules, and grid choices with no process group and no second
process. Counterpart of ``repro.verify.comm``.

The reference traces every ``shard_map`` program with ``jax.make_jaxpr``
on a device-free ``AbstractMesh`` and walks the jaxpr for collectives. The
port's programs are plain PyTorch on process groups, so its counterpart is
a transport that moves nothing: ``collectives.Group`` with
``backend="abstract"`` (:data:`~repro_torch.distributed.collectives.ABSTRACT`)
returns each collective's result shape as if every rank held this rank's
operand and counts the same ring bytes into ``COUNTER`` as a real group
would. :func:`~repro_torch.distributed.mesh.abstract_grid_mesh` builds one
rank's mesh over such groups, and the sweep builders run on it unchanged,
one rank after another, in this process, on ``backend="einsum"`` CPU
tensors.

Only the shapes and the bytes are meaningful there. Under this transport
a ring consumer's "chunk that arrived" is this rank's own chunk, a sum is
q times the operand, and the solves and ``eigh`` see those values: they
stay finite, so the programs run through, but no check here reads a value.

Three rule families, the reference's:

* **Byte model** — every rank's counted bytes of the CP sweep equal
  ``stationary_sweep_words`` x itemsize (+ the fit scalar's all-reduce),
  the Tucker sweep's ``multi_ttm_sweep_words`` x itemsize, and single-mode
  ``mttkrp_stationary``'s Eq (12) x itemsize — exactly, in both
  ``overlap="none"`` and ``overlap="ring"`` spellings
  (``byte-model-mismatch``); every rank counts the same
  (``rank-asymmetry``); each sits at or above the clamped Thm 4.2/4.3
  parallel lower bound (``below-lower-bound``); ``overlap="ring"`` counts
  no all-gather and no reduce-scatter (``ring-not-chunked``).
* **Ring schedule** — :mod:`repro_torch.distributed.ring`'s schedule as
  integer functions (``ring_perm`` / ``arrival_source`` /
  ``reduce_chunk_index``), simulated for every ring size: one q-cycle,
  arrivals as the runtime's provenance arithmetic says, no read before
  arrival, every slot written once, the reduce-scatter's block ``j`` on
  rank ``j`` with every contribution once.
* **Grid selection** — ``select_stationary_grid`` / ``select_tucker_grid``
  return brute-force-optimal grids on the lattice.

No Hopper kernel launches (``kernel-executed``: every wrapper's launch
count is the same after the analysis).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

from . import Finding

#: The f32 lattice itemsize every byte check uses.
ITEMSIZE = 4

#: CP-sweep lattice: (dims, rank, grid). Grid axes are chosen so every
#: per-collective byte term is integral — per-op int() truncation then
#: equals the global model's, and equality is exact, not approximate.
CP_CASES: tuple[tuple[tuple[int, ...], int, tuple[int, ...]], ...] = (
    ((8, 8, 8), 4, (2, 2, 2)),
    ((8, 8, 8), 4, (1, 2, 2)),
    ((16, 8, 8), 4, (4, 2, 1)),
    ((8, 8, 8, 8), 4, (1, 2, 2, 2)),
    ((8, 8, 8, 8), 4, (2, 2, 1, 2)),
)

#: Tucker-sweep lattice: (dims, ranks, grid).
TUCKER_CASES: tuple[
    tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]], ...
] = (
    ((16, 16, 16), (4, 3, 2), (2, 2, 2)),
    ((16, 16, 16), (4, 3, 2), (1, 2, 4)),
    ((16, 16, 16), (4, 3, 2), (4, 2, 1)),
    ((8, 8, 8, 8), (2, 2, 2, 2), (2, 2, 1, 2)),
)

#: Single-mode Alg-3 lattice: (dims, rank, grid, mode).
MTTKRP_CASES: tuple[
    tuple[tuple[int, ...], int, tuple[int, ...], int], ...
] = (
    ((8, 8, 8), 4, (2, 2, 2), 0),
    ((8, 8, 8), 4, (2, 2, 2), 1),
    ((8, 8, 8), 4, (2, 2, 2), 2),
    ((16, 8, 8), 4, (4, 2, 1), 0),
)

OVERLAPS = ("none", "ring")

#: Ring sizes the schedule verifier proves (q=1 is the degenerate
#: no-communication ring; primes and composites both appear).
RING_SIZES = (1, 2, 3, 4, 5, 6, 7, 8)

#: Grid-selection cases pinned against brute force: (dims, rank, procs).
GRID_SELECT_CASES = (
    ((8, 8, 8), 4, 8),
    ((16, 8, 8), 4, 8),
    ((16, 16, 8), 4, 4),
)
TUCKER_SELECT_CASES = (
    ((16, 16, 16), (4, 3, 2), 8),
    ((8, 8, 8, 8), (2, 2, 2, 2), 8),
)
#: The seed of the lattice's tensors and factors.
SEED = 0


# --------------------------------------------------------------------------
# Byte models (pure arithmetic; must mirror the builders exactly)
# --------------------------------------------------------------------------

def cp_sweep_model_bytes(
    dims: Sequence[int], rank: int, grid: Sequence[int],
    itemsize: int = ITEMSIZE, compute_fit: bool = True,
) -> int:
    """Expected ring bytes of one ``build_cp_sweep`` program on one rank:
    the BHK sweep model (``stationary_sweep_words``) times itemsize, plus
    the fit scalar's all-reduce (one float over all P processors)."""
    from ..distributed.grid_select import stationary_sweep_words

    b = int(stationary_sweep_words(dims, rank, grid) * itemsize)
    if compute_fit:
        p = math.prod(grid)
        b += int(2 * (p - 1) / p * itemsize)
    return b


def tucker_sweep_model_bytes(
    dims: Sequence[int], ranks: Sequence[int], grid: Sequence[int],
    itemsize: int = ITEMSIZE,
) -> int:
    """Expected ring bytes of one ``build_tucker_sweep`` program."""
    from ..distributed.grid_select import multi_ttm_sweep_words

    return int(multi_ttm_sweep_words(dims, ranks, grid) * itemsize)


def mttkrp_model_bytes(
    dims: Sequence[int], rank: int, grid: Sequence[int], mode: int,
    itemsize: int = ITEMSIZE,
) -> int:
    """Expected ring bytes of one single-mode Alg-3 call: Eq (12)."""
    from ..core.bounds import par_stationary_cost

    return int(par_stationary_cost(dims, rank, grid, mode) * itemsize)


def parallel_lb_bytes(
    dims: Sequence[int], rank: int, procs: int, itemsize: int = ITEMSIZE,
) -> int:
    """Clamped Thm 4.2/4.3 lower bound in bytes: the larger of the
    general and stationary-variant bounds, floored at zero (on the small
    lattice shapes the asymptotic expressions can go negative)."""
    from ..core.bounds import par_lb_general, par_lb_stationary

    lb = max(
        0.0,
        par_lb_general(dims, rank, procs),
        par_lb_stationary(dims, rank, procs),
    )
    return int(lb * itemsize)


# --------------------------------------------------------------------------
# Every rank's program on the abstract transport
# --------------------------------------------------------------------------

def _operands(dims: Sequence[int], cols: Sequence[int]):
    """The lattice point's tensor and matrices (``(d, c)`` each), float32
    CPU tensors from :data:`SEED`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal(tuple(dims), dtype=np.float32))
    mats = [torch.from_numpy(rng.standard_normal((d, c), dtype=np.float32))
            for d, c in zip(dims, cols)]
    return x, mats


def count_ranks(grid: Sequence[int], program: Callable) -> list[dict]:
    """Run ``program(mesh)`` for every rank of ``grid``, one after another,
    each on its :func:`~repro_torch.distributed.mesh.abstract_grid_mesh`;
    returns each rank's collectives by kind (a ``COUNTER`` delta)."""
    from ..distributed.collectives import COUNTER
    from ..distributed.mesh import abstract_grid_mesh, make_abstract_grid_mesh

    layout = make_abstract_grid_mesh(grid)
    out = []
    for r in range(layout.size):
        mesh = abstract_grid_mesh(layout, r)
        before = COUNTER.snapshot()
        program(mesh)
        out.append(COUNTER.delta(before))
    return out


def check_program_bytes(
    subject: str,
    measured_bytes: int,
    model_bytes: int,
    lb_bytes: int,
) -> list[Finding]:
    """The two byte rules: counted == model (exactly) and counted >= the
    clamped parallel lower bound."""
    findings: list[Finding] = []
    if measured_bytes != model_bytes:
        findings.append(Finding(
            "comm", "byte-model-mismatch", subject,
            f"counted collective ring bytes {measured_bytes} != sweep-model "
            f"{model_bytes} (the program's collectives drifted from the "
            f"paper's cost model)",
        ))
    if measured_bytes < lb_bytes:
        findings.append(Finding(
            "comm", "below-lower-bound", subject,
            f"counted collective ring bytes {measured_bytes} < clamped "
            f"parallel lower bound {lb_bytes} (the byte accounting must "
            f"be wrong: no schedule beats Thm 4.2/4.3)",
        ))
    return findings


def _point(subject: str, ranks: list[dict], model: int, lb: int) -> tuple[list[Finding], int]:
    """The byte rules on every rank of a point: each rank's bytes against
    the model and the bound, and every rank the same; returns the findings
    and rank 0's bytes."""
    from ..distributed.collectives import ring_total

    counted = [ring_total(d) for d in ranks]
    findings: list[Finding] = []
    for r, b in enumerate(counted):
        findings += check_program_bytes(f"{subject} rank={r}", b, model, lb)
    if len(set(counted)) > 1:
        findings.append(Finding(
            "comm", "rank-asymmetry", subject,
            f"ranks count different bytes {counted}: the program is not the "
            f"same on every rank of the grid",
        ))
    return findings, counted[0]


def _kinds(ranks: list[dict]) -> dict[str, int]:
    """Rank 0's collectives, by kind: their count."""
    return {k: int(v["count"]) for k, v in ranks[0].items()}


def _verdict(name, dims, rank, grid, overlap, model, lb, measured, ranks, findings) -> dict:
    return {
        "analyzer": "comm", "name": name,
        "shape": list(dims), "rank": rank if isinstance(rank, int) else list(rank),
        "grid": list(grid), "overlap": overlap, "procs": math.prod(grid),
        "itemsize": ITEMSIZE, "modeled_words": model / ITEMSIZE,
        "lower_bound_words": lb / ITEMSIZE,
        "measured_collective_bytes": measured,
        "collectives": _kinds(ranks), "transport": "abstract",
        "agrees": not findings, "findings": len(findings),
    }


def _ring_not_chunked(subject: str, ranks: list[dict]) -> list[Finding]:
    mono = sorted({k for d in ranks for k in d if k in ("all-gather", "reduce-scatter")})
    if not mono:
        return []
    return [Finding(
        "comm", "ring-not-chunked", subject,
        f"overlap='ring' program still emits monolithic {mono} "
        f"(the permute spelling regressed)",
    )]


def check_cp_sweep(
    dims: tuple[int, ...], rank: int, grid: tuple[int, ...], overlap: str,
) -> tuple[list[Finding], dict]:
    """Run one CP sweep on every rank of ``grid`` on the abstract transport
    and apply the byte rules."""
    from ..core.tensor import frob_norm
    from ..distributed.cp_als_parallel import build_cp_sweep, place_cp_state
    from ..engine.context import ExecutionContext

    ctx = ExecutionContext.create("einsum", device="cpu", grid=grid, overlap=overlap)
    x, factors = _operands(dims, [rank] * len(dims))
    normx = frob_norm(x)

    def program(mesh):
        build_cp_sweep(mesh, len(dims), ctx=ctx)(*place_cp_state(mesh, x, factors), normx)

    ranks = count_ranks(grid, program)
    model = cp_sweep_model_bytes(dims, rank, grid)
    lb = parallel_lb_bytes(dims, rank, math.prod(grid))
    subject = f"cp_sweep dims={dims} rank={rank} grid={grid} overlap={overlap}"
    findings, measured = _point(subject, ranks, model, lb)
    if overlap == "ring":
        findings += _ring_not_chunked(subject, ranks)
    return findings, _verdict(f"cp_sweep/{overlap}", dims, rank, grid, overlap, model, lb,
                              measured, ranks, findings)


def check_tucker_sweep(
    dims: tuple[int, ...], ranks: tuple[int, ...], grid: tuple[int, ...], overlap: str,
) -> tuple[list[Finding], dict]:
    """Run one Tucker/HOOI sweep on every rank of ``grid``; byte rules."""
    from ..core.tensor import frob_norm
    from ..distributed.tucker_parallel import build_tucker_sweep, place_tucker_state
    from ..engine.context import ExecutionContext

    ctx = ExecutionContext.create("einsum", device="cpu", grid=grid, overlap=overlap)
    x, factors = _operands(dims, ranks)
    normx = frob_norm(x)

    def program(mesh):
        build_tucker_sweep(mesh, len(dims), ranks, ctx=ctx)(
            *place_tucker_state(mesh, x, factors), normx)

    per_rank = count_ranks(grid, program)
    model = tucker_sweep_model_bytes(dims, ranks, grid)
    # no parallel Multi-TTM lower bound is implemented in core/bounds.py
    # (arXiv:2207.10437's parallel case); the clamped bound is 0 — the
    # byte-equality rule is the binding one here.
    lb = 0
    subject = f"tucker_sweep dims={dims} ranks={ranks} grid={grid} overlap={overlap}"
    findings, measured = _point(subject, per_rank, model, lb)
    return findings, _verdict(f"tucker_sweep/{overlap}", dims, ranks, grid, overlap, model, lb,
                              measured, per_rank, findings)


def check_mttkrp_stationary(
    dims: tuple[int, ...], rank: int, grid: tuple[int, ...], mode: int,
) -> tuple[list[Finding], dict]:
    """Run one single-mode Alg-3 program on every rank; Eq (12) byte
    rules."""
    from ..distributed.mttkrp_parallel import mttkrp_stationary, place_inputs
    from ..engine.context import ExecutionContext

    ctx = ExecutionContext.create("einsum", device="cpu", grid=grid)
    x, factors = _operands(dims, [rank] * len(dims))

    def program(mesh):
        xs, fs = place_inputs(mesh, x, factors, mode)
        mttkrp_stationary(mesh, mode, len(dims), ctx=ctx)(xs, *fs)

    ranks = count_ranks(grid, program)
    model = mttkrp_model_bytes(dims, rank, grid, mode)
    lb = parallel_lb_bytes(dims, rank, math.prod(grid))
    subject = f"mttkrp_stationary dims={dims} rank={rank} grid={grid} mode={mode}"
    findings, measured = _point(subject, ranks, model, lb)
    return findings, _verdict(f"mttkrp_stationary/m{mode}", dims, rank, grid, "none", model, lb,
                              measured, ranks, findings)


# --------------------------------------------------------------------------
# Ring-schedule verifier (pure integer simulation)
# --------------------------------------------------------------------------

def check_ring_permutation(
    perm: Sequence[tuple[int, int]], q: int, subject: str,
) -> list[Finding]:
    """Deadlock-freedom: the permute pairs must form one q-cycle.

    A permutation that splits into multiple cycles (or maps two sources
    to one destination) would deadlock a rendezvous ring or silently
    drop a shard — the classic two-cycle bug this fixture class seeds.
    """
    findings: list[Finding] = []
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if sorted(srcs) != list(range(q)) or sorted(dsts) != list(range(q)):
        findings.append(Finding(
            "comm", "ring-deadlock", subject,
            f"permute pairs are not a permutation of 0..{q - 1}: "
            f"srcs={sorted(srcs)} dsts={sorted(dsts)}",
        ))
        return findings
    nxt = dict(perm)
    seen = {0}
    node = 0
    for _ in range(q - 1):
        node = nxt[node]
        seen.add(node)
    if len(seen) != q:
        findings.append(Finding(
            "comm", "ring-deadlock", subject,
            f"permutation {list(perm)} splits into multiple cycles "
            f"(cycle through 0 visits only {len(seen)}/{q} shards): a "
            f"ring schedule built on it never sees every chunk",
        ))
    return findings


def simulate_ring_arrivals(
    q: int, perm: Sequence[tuple[int, int]] | None = None,
) -> list[list[int]]:
    """Origin labels under the actual permute dataflow:
    ``arrivals[t][me]`` is which processor's shard ``me`` holds after
    ``t`` ring steps (step 0 = its own)."""
    from ..distributed.ring import ring_perm

    perm = ring_perm(q) if perm is None else perm
    recv_from = {dst: src for src, dst in perm}
    hold = list(range(q))
    arrivals = [list(hold)]
    for _ in range(1, q):
        hold = [hold[recv_from[me]] for me in range(q)]
        arrivals.append(list(hold))
    return arrivals


def check_gather_schedule(q: int, subject: str) -> list[Finding]:
    """Prove the runtime's provenance arithmetic against the simulated
    dataflow, plus write-once and exact coverage of the gathered factor."""
    from ..distributed.ring import arrival_source

    findings: list[Finding] = []
    arrivals = simulate_ring_arrivals(q)
    for me in range(q):
        got = [arrivals[t][me] for t in range(q)]
        for t in range(q):
            want = arrival_source(me, t, q)
            if got[t] != want:
                findings.append(Finding(
                    "comm", "ring-schedule-mismatch", subject,
                    f"proc {me} step {t}: simulated arrival is from "
                    f"{got[t]} but arrival_source says {want} — the "
                    f"consumers would slice the wrong tensor chunk",
                ))
        if len(set(got)) != q:
            findings.append(Finding(
                "comm", "ring-coverage", subject,
                f"proc {me}: arrivals {got} do not cover every source "
                f"exactly once (the assembled factor has holes or "
                f"double-written slots)",
            ))
    return findings


def check_assembly(q: int, subject: str) -> list[Finding]:
    """Prove ``ring_assemble``'s placement (arrival ``t`` at index
    ``arrival_source(me, t, q)``) against the simulated dataflow: every
    slot of the gathered buffer holds its own source's shard, written once
    (so ``ring_all_gather`` equals ``all_gather``'s tiled order)."""
    from ..distributed.ring import arrival_source

    findings: list[Finding] = []
    arrivals = simulate_ring_arrivals(q)
    for me in range(q):
        assembled: list[int | None] = [None] * q
        for t in range(q):
            slot = arrival_source(me, t, q)
            if assembled[slot] is not None:
                findings.append(Finding(
                    "comm", "ring-assembly", subject,
                    f"proc {me}: slot {slot} written twice (arrival {t}) — "
                    f"ring_all_gather would drop a shard",
                ))
            assembled[slot] = arrivals[t][me]
        if assembled != list(range(q)):
            findings.append(Finding(
                "comm", "ring-assembly", subject,
                f"proc {me}: assembled block order {assembled} != tiled "
                f"order {list(range(q))} — ring_all_gather would not "
                f"match all_gather's",
            ))
    return findings


def check_consumer_schedule(
    q: int,
    subject: str,
    source_fn: Callable[[int, int, int], int] | None = None,
) -> list[Finding]:
    """The overlap consumer's contract: at step ``t`` it contracts the
    chunk from ``source_fn(me, t, q)``. That chunk physically arrives at
    step ``(me - source) mod q``, so the consumer must never reference a
    source whose arrival step exceeds ``t`` (a read-before-arrival race
    on real async hardware), and over all steps must consume every
    source exactly once."""
    from ..distributed.ring import arrival_source

    source_fn = arrival_source if source_fn is None else source_fn
    findings: list[Finding] = []
    for me in range(q):
        consumed: list[int] = []
        for t in range(q):
            src = source_fn(me, t, q)
            arrival_step = (me - src) % q
            if arrival_step > t:
                findings.append(Finding(
                    "comm", "read-before-arrival", subject,
                    f"proc {me} step {t}: consumes chunk from source "
                    f"{src}, which only arrives at step {arrival_step}",
                ))
            consumed.append(src)
        if len(set(consumed)) != q:
            findings.append(Finding(
                "comm", "ring-coverage", subject,
                f"proc {me}: consumer touches sources {consumed} — not "
                f"every chunk of the gathered factor exactly once",
            ))
    return findings


def check_reduce_scatter_schedule(
    q: int,
    subject: str,
    chunk_fn: Callable[[int, int, int], int] | None = None,
) -> list[Finding]:
    """Simulate the reduce-scatter ring's contribution sets: after q-1
    forward hops, processor ``j`` must hold block ``j`` with every
    processor's contribution counted exactly once."""
    from ..distributed.ring import reduce_chunk_index

    chunk_fn = reduce_chunk_index if chunk_fn is None else chunk_fn
    findings: list[Finding] = []
    acc: list[set[tuple[int, int]]] = [
        {(me, chunk_fn(me, 0, q))} for me in range(q)
    ]
    for t in range(1, q):
        moved = [acc[(me - 1) % q] for me in range(q)]
        nxt: list[set[tuple[int, int]]] = []
        for me in range(q):
            contrib = (me, chunk_fn(me, t, q))
            if contrib in moved[me]:
                findings.append(Finding(
                    "comm", "ring-write-once", subject,
                    f"proc {me} step {t}: chunk {contrib[1]} folded in "
                    f"twice — the reduced block double-counts a term",
                ))
            nxt.append(moved[me] | {contrib})
        acc = nxt
    for j in range(q):
        want = {(p, j) for p in range(q)}
        if acc[j] != want:
            findings.append(Finding(
                "comm", "ring-reduction-coverage", subject,
                f"proc {j} ends with contributions {sorted(acc[j])} != "
                f"every processor's block-{j} chunk exactly once",
            ))
    return findings


def check_ring_schedules(q: int) -> list[Finding]:
    """All ring-schedule rules for one ring size."""
    from ..distributed.ring import ring_perm

    subject = f"ring q={q}"
    findings = check_ring_permutation(ring_perm(q), q, subject)
    findings += check_gather_schedule(q, subject)
    findings += check_assembly(q, subject)
    findings += check_consumer_schedule(q, subject)
    findings += check_reduce_scatter_schedule(q, subject)
    return findings


# --------------------------------------------------------------------------
# Grid selection vs brute force
# --------------------------------------------------------------------------

def check_grid_selection(
    dims: tuple[int, ...], rank: int, procs: int,
) -> list[Finding]:
    """The branch-and-bound CP grid must match exhaustive search."""
    from ..distributed.grid_select import (
        brute_force_stationary,
        select_stationary_grid,
    )

    subject = f"select_stationary_grid dims={dims} rank={rank} P={procs}"
    sel = select_stationary_grid(dims, rank, procs, mode=None)
    ref = brute_force_stationary(dims, rank, procs, mode=None)
    if (sel is None) != (ref is None):
        return [Finding(
            "comm", "grid-suboptimal", subject,
            f"feasibility disagrees: select={sel} brute={ref}",
        )]
    if sel is not None and ref is not None and not math.isclose(
        sel.words, ref.words, rel_tol=0.0, abs_tol=1e-9
    ):
        return [Finding(
            "comm", "grid-suboptimal", subject,
            f"selected grid {sel.grid} costs {sel.words} words but brute "
            f"force finds {ref.grid} at {ref.words}",
        )]
    return []


def check_tucker_grid_selection(
    dims: tuple[int, ...], ranks: tuple[int, ...], procs: int,
) -> list[Finding]:
    """The Tucker grid chooser must match exhaustive search."""
    from ..distributed.grid_select import (
        brute_force_tucker,
        select_tucker_grid,
    )

    subject = f"select_tucker_grid dims={dims} ranks={ranks} P={procs}"
    sel = select_tucker_grid(dims, ranks, procs)
    ref = brute_force_tucker(dims, ranks, procs)
    if (sel is None) != (ref is None):
        return [Finding(
            "comm", "grid-suboptimal", subject,
            f"feasibility disagrees: select={sel} brute={ref}",
        )]
    if sel is not None and ref is not None and not math.isclose(
        sel.words, ref.words, rel_tol=0.0, abs_tol=1e-9
    ):
        return [Finding(
            "comm", "grid-suboptimal", subject,
            f"selected grid {sel.grid} costs {sel.words} words but brute "
            f"force finds {ref.grid} at {ref.words}",
        )]
    return []


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

def verify_comm(
    cp_cases: Sequence = CP_CASES,
    tucker_cases: Sequence = TUCKER_CASES,
    mttkrp_cases: Sequence = MTTKRP_CASES,
    ring_sizes: Sequence[int] = RING_SIZES,
) -> tuple[list[Finding], list[dict]]:
    """Run the full lattice. Returns ``(findings, verdicts)`` — one
    verdict dict per program point (trace-schema-ready: the report CLI
    tables ``modeled_words`` / ``lower_bound_words`` /
    ``measured_collective_bytes`` per grid) plus one summary verdict
    each for the ring-schedule and grid-selection rule families."""
    from .kernels import kernel_executed, wrapper_launches

    before = wrapper_launches()
    findings: list[Finding] = []
    verdicts: list[dict] = []
    for dims, rank, grid in cp_cases:
        for overlap in OVERLAPS:
            f, v = check_cp_sweep(dims, rank, grid, overlap)
            findings += f
            verdicts.append(v)
    for dims, ranks, grid in tucker_cases:
        for overlap in OVERLAPS:
            f, v = check_tucker_sweep(dims, ranks, grid, overlap)
            findings += f
            verdicts.append(v)
    for dims, rank, grid, mode in mttkrp_cases:
        f, v = check_mttkrp_stationary(dims, rank, grid, mode)
        findings += f
        verdicts.append(v)

    ring_findings: list[Finding] = []
    for q in ring_sizes:
        ring_findings += check_ring_schedules(q)
    findings += ring_findings
    verdicts.append({
        "analyzer": "comm", "name": "ring_schedule",
        "ring_sizes": list(ring_sizes),
        "agrees": not ring_findings, "findings": len(ring_findings),
    })

    grid_findings: list[Finding] = []
    for dims, rank, procs in GRID_SELECT_CASES:
        grid_findings += check_grid_selection(dims, rank, procs)
    for dims, ranks, procs in TUCKER_SELECT_CASES:
        grid_findings += check_tucker_grid_selection(dims, ranks, procs)
    findings += grid_findings
    verdicts.append({
        "analyzer": "comm", "name": "grid_selection",
        "cases": len(GRID_SELECT_CASES) + len(TUCKER_SELECT_CASES),
        "agrees": not grid_findings, "findings": len(grid_findings),
    })

    findings += kernel_executed("comm", before, "verify_comm")
    return findings, verdicts
