"""Ring-chunked collectives: the sweep's all-gather and reduce-scatter as
rounds of point-to-point sends with the same ring traffic. Counterpart of
``repro.distributed.ring``.

In the stationary CP sweep every factor's all-gather stands between that
factor's update and the next mode's local MTTKRP. Spelled as its own ring
(q-1 rounds, each moving one shard one hop), the gather exposes each
chunk as it lands, and a consumer that contracts chunk t as it arrives
(``cp_als_parallel``'s ``overlap="ring"``) works on the chunks that are
already there.

Traffic is the same as the monolithic collectives': an all-gather of an
``n``-byte shard over ``q`` ranks costs ``(q-1) * n`` on a ring, and so do
the ``q-1`` permutes of one ``n``-byte chunk here; a reduce-scatter of a
``q*n``-byte operand costs ``(q-1) * n``, and so does this one. Each hop is
one :func:`~.collectives.permute` and is counted as one
``collective-permute``.

Linearization: the ring runs over the group's order, row-major over its
axes (first listed outermost), the order ``all_gather(..., tiled=True)``
concatenates in, so the assembled results equal the monolithic ones' (sums
differ in association only).

The schedule is data: :func:`ring_perm`, :func:`arrival_source` and
:func:`reduce_chunk_index` are the reference's integer functions, copied,
and both the collectives here and the overlap consumer index through them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .collectives import Group, permute


def ring_perm(q: int) -> list[tuple[int, int]]:
    """The forward ring: shard ``i`` sends to ``i+1 mod q`` (shard ``j``
    receives from ``j-1``). A single q-cycle: every round is deadlock-free
    and conflict-free."""
    return [(i, (i + 1) % q) for i in range(q)]


def arrival_source(me: int, t: int, q: int) -> int:
    """Ring source of the chunk that arrives at round ``t`` on rank ``me``
    under :func:`ring_perm`: ``(me - t) mod q``. Round 0 is the local
    shard."""
    return (me - t) % q


def reduce_chunk_index(me: int, t: int, q: int) -> int:
    """Local chunk folded into the accumulator at reduce-scatter round
    ``t`` on rank ``me``: ``(me - t - 1) mod q``, the block destined
    ``t+1`` hops downstream. Round 0 seeds the accumulator; rounds 1..q-1
    each follow one hop."""
    return (me - t - 1) % q


def ring_all_gather_parts(x: torch.Tensor, group: Group) -> list[torch.Tensor]:
    """The raw ring schedule: ``q`` chunks, ``parts[t]`` the chunk that
    arrives at round ``t``, from ring source ``arrival_source(me, t, q)``
    (``parts[0]`` is this rank's own shard). ``q-1`` hops in all."""
    parts = [x]
    acc = x
    for _ in range(1, group.size):
        acc = permute(acc, group)
        parts.append(acc)
    return parts


def ring_assemble(parts: Sequence[torch.Tensor], group: Group) -> torch.Tensor:
    """Order ring arrivals into the ``all_gather(..., tiled=True)`` layout:
    arrival ``t`` lands at its source's index."""
    q = len(parts)
    if q == 1:
        return parts[0]
    by_source: list[torch.Tensor] = [parts[0]] * q
    for t, part in enumerate(parts):
        by_source[arrival_source(group.me, t, q)] = part
    return torch.cat(by_source, dim=0)


def ring_all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """:func:`~.collectives.all_gather` as a ring: the same result, the
    same ring traffic, chunk by chunk."""
    return ring_assemble(ring_all_gather_parts(x, group), group)


def ring_reduce_scatter(c: torch.Tensor, group: Group) -> torch.Tensor:
    """:func:`~.collectives.reduce_scatter` as a ring: each round forwards
    a partial sum one hop and folds in the local chunk
    :func:`reduce_chunk_index` selects; after ``q-1`` rounds rank ``j``
    holds block ``j`` summed. Sums associate in ring order, so results
    match the monolithic one's to floating-point tolerance."""
    q = group.size
    if q == 1:
        return c
    if c.shape[0] % q:
        raise ValueError(f"ring_reduce_scatter: {c.shape[0]} rows do not split over {q} ranks")
    rows = c.shape[0] // q
    me = group.me

    def chunk(i: int) -> torch.Tensor:
        return c[i * rows:(i + 1) * rows]

    acc = chunk(reduce_chunk_index(me, 0, q))
    for t in range(1, q):
        acc = permute(acc, group) + chunk(reduce_chunk_index(me, t, q))
    return acc
