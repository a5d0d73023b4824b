"""Decomposition as a service: bucket, pad, batch; one plan a bucket.
Counterpart of ``repro.launch.serve``.

The serving layer on the batched engine (:mod:`repro_torch.engine.batch`).
Each request (one tensor, a CP rank, its dtype) is **bucketed** by its
tune-cache key: extents round up to the bucket quantum (``pad_to``), and
requests whose padded shape, rank, dtype and memory model agree land in one
bucket. A flush writes each bucket's requests into one preallocated zero
``(B, I_0, ..., I_{N-1})`` tensor on the context's device and runs ONE
:func:`~repro_torch.engine.batch.cp_als_batched` call a bucket: one plan
resolution and, on ``cuda``, one kernel launch a contraction for all B
requests.

Padding is exact: a zero-padded tensor with zero-padded initial factors
evolves as the unpadded run under CP-ALS (padded MTTKRP rows are zero, so
padded factor rows stay zero and add nothing to any Gram), so the cropped
result is the unpadded answer, to float32 rounding.

Initial factors: request i of a server (from 0, in flush order) is seeded
with ``i + 1``, as the reference seeds it with ``PRNGKey(i + 1)``; torch
cannot reproduce JAX's draws, so the factors come from a
``torch.Generator`` on the context's device, drawn on the element shape
and zero-padded. ``submit(..., init_factors=...)`` takes explicit factors
in their place.

Warm starts across processes: a context with ``compilation_cache=<dir>``
makes the server call ``ensure_compilation_cache()`` in ``__init__``, so
the kernels are built into that directory and a second server process
loads them from it instead of running ``nvcc``.

CLI demo (synthetic workload, prints req/s)::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --requests 16 --shape 96x96x96 --rank 16 --cache-dir /tmp/srv
"""

from __future__ import annotations

import argparse
import time
import uuid
from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..engine.context import ExecutionContext
from ..engine.plan import Memory
from ..observe import trace as _otrace

#: Default bucket quantum: extents round up to the next multiple.
DEFAULT_PAD_TO = 8


def bucket_shape(shape: Sequence[int], pad_to: int = DEFAULT_PAD_TO) -> tuple[int, ...]:
    """The plan shape a request's tensor is padded to: each extent rounded
    up to the next multiple of ``pad_to``, so nearby shapes share a bucket
    (and so one plan)."""
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    return tuple(-(-int(s) // pad_to) * pad_to for s in shape)


def bucket_key(
    shape: Sequence[int],
    rank: int,
    dtype,
    *,
    memory: Memory | None = None,
    pad_to: int = DEFAULT_PAD_TO,
    device=None,
) -> str:
    """The bucket's identity: the tune-cache key of the PADDED problem
    (``kind="serve"``), so two requests share a bucket exactly when the
    engine would resolve them to the same plan. ``device`` is where the
    bucket runs (the key's platform field)."""
    from ..tune.cache import cache_key  # call-time: launch sits above tune

    mem = memory or Memory.abstract(2 ** 20)
    return cache_key(bucket_shape(shape, pad_to), rank, 0, dtype, mem, kind="serve",
                     device=device)


def _crop(shape: Sequence[int]) -> tuple[slice, ...]:
    return tuple(slice(0, int(s)) for s in shape)


def pad_to_bucket(x: torch.Tensor, padded: Sequence[int]) -> torch.Tensor:
    """``x`` zero-padded up to the bucket's plan shape (exact for CP-ALS:
    see the module docstring); ``x`` itself when it has that shape."""
    if tuple(x.shape) == tuple(padded):
        return x
    if any(int(p) < int(s) for s, p in zip(x.shape, padded)) or len(padded) != x.ndim:
        raise ValueError(f"cannot pad shape {tuple(x.shape)} down to {tuple(padded)}")
    out = torch.zeros(tuple(padded), dtype=x.dtype, device=x.device)
    out[_crop(x.shape)] = x
    return out


@dataclass
class Request:
    """One queued decomposition request."""

    request_id: str
    x: torch.Tensor
    rank: int
    key: str  # bucket key
    init_factors: list[torch.Tensor] | None = None
    enqueued_at: float = field(default_factory=time.perf_counter)


@dataclass
class ServeResult:
    """One served decomposition: the request's cropped CP result and the
    serving telemetry (bucket, batch size, queue and execute seconds,
    whether this flush ran the bucket for the first time in this server)."""

    request_id: str
    factors: list[torch.Tensor]
    weights: torch.Tensor
    fit: float
    n_iters: int
    converged: bool
    bucket: str
    batch: int
    queue_s: float
    execute_s: float
    cold: bool


class DecompositionServer:
    """The request queue and its batched executor.

    ``submit()`` enqueues a tensor; ``flush()`` groups the queue into
    buckets (equal :func:`bucket_key`), writes each bucket into one padded
    batch, runs ONE :func:`~repro_torch.engine.batch.cp_als_batched` call a
    bucket and returns each request's cropped :class:`ServeResult`.
    Per-element convergence masks freeze the requests of a bucket that
    converge early while the rest iterate.

    ``ctx`` defaults to ``ExecutionContext.default()`` (the Hopper kernels on the
    card). With ``ctx.observe`` on and an active
    :class:`repro_torch.observe.Trace`, each flush records a ``serve_bucket``
    event a bucket and a ``serve_request`` event a request, as the
    reference's server does, beside the engine's own spans."""

    def __init__(
        self,
        ctx: ExecutionContext | None = None,
        *,
        pad_to: int = DEFAULT_PAD_TO,
        n_iters: int = 20,
        tol: float = 1e-4,
    ):
        self.ctx = ctx if ctx is not None else ExecutionContext.default()
        self.pad_to = int(pad_to)
        bucket_shape((1,), self.pad_to)  # validate the quantum now
        self.n_iters = int(n_iters)
        self.tol = float(tol)
        self._queue: list[Request] = []
        self._seen_buckets: set[str] = set()
        self._seed = 0
        # point the kernels' builds at the context's directory BEFORE the
        # first launch, so a warm-start process loads them from disk
        self.ctx.ensure_compilation_cache()

    def __len__(self) -> int:
        return len(self._queue)

    def submit(
        self,
        x: torch.Tensor,
        rank: int,
        request_id: str | None = None,
        *,
        init_factors: Sequence[torch.Tensor] | None = None,
    ) -> str:
        """Enqueue one tensor for CP decomposition; returns the request id
        (made up when not given). ``init_factors`` (one ``(I_k, R)`` a mode)
        replace the server's seeded draw. Nothing runs until :meth:`flush`."""
        if x.ndim < 2:
            raise ValueError(f"serve requests are >=2-way tensors, got shape {tuple(x.shape)}")
        self.ctx.check_tensor("repro_torch.DecompositionServer.submit", x,
                              *(init_factors or ()))
        if init_factors is not None:
            init_factors = [f.to(x.dtype) for f in init_factors]
            if [tuple(f.shape) for f in init_factors] != [(int(s), int(rank)) for s in x.shape]:
                raise ValueError(f"init_factors must be (I_k, R) for shape {tuple(x.shape)}, "
                                 f"R={rank}")
        rid = request_id if request_id is not None else uuid.uuid4().hex
        key = bucket_key(x.shape, rank, x.dtype, memory=self.ctx.memory, pad_to=self.pad_to,
                         device=self.ctx.device)
        self._queue.append(Request(rid, x, int(rank), key, init_factors))
        return rid

    def _inits(self, reqs: list[Request], padded, rank, dtype) -> list[torch.Tensor]:
        """Every request's initial factors on its element shape (explicit,
        or drawn with seed i + 1 for the server's i-th request), written
        into zero ``(B, padded_k, R)`` stacks."""
        from ..core.tensor import random_factors

        out = [torch.zeros((len(reqs), p, rank), dtype=dtype, device=self.ctx.torch_device)
               for p in padded]
        for b, r in enumerate(reqs):
            self._seed += 1
            fs = r.init_factors
            if fs is None:
                gen = torch.Generator(device=self.ctx.torch_device).manual_seed(self._seed)
                fs = random_factors(gen, r.x.shape, rank, dtype)
            for k, f in enumerate(fs):
                out[k][b, : f.shape[0]] = f
        return out

    def flush(self) -> dict[str, ServeResult]:
        """Run the queue, one batched call a bucket; returns
        ``{request_id: ServeResult}`` and empties the queue."""
        from ..engine.batch import cp_als_batched

        queue, self._queue = self._queue, []
        buckets: dict[str, list[Request]] = {}
        for req in queue:
            buckets.setdefault(req.key, []).append(req)
        out: dict[str, ServeResult] = {}
        for key, reqs in buckets.items():
            t0 = time.perf_counter()
            cold = key not in self._seen_buckets
            self._seen_buckets.add(key)
            padded = bucket_shape(reqs[0].x.shape, self.pad_to)
            rank, dtype = reqs[0].rank, reqs[0].x.dtype
            # one zero batch, each request written into its corner (no
            # padded copies to stack)
            xs = torch.zeros((len(reqs), *padded), dtype=dtype, device=self.ctx.torch_device)
            for b, r in enumerate(reqs):
                xs[b][_crop(r.x.shape)] = r.x
            res = cp_als_batched(xs, rank, self.n_iters,
                                 init_factors=self._inits(reqs, padded, rank, dtype),
                                 tol=self.tol, ctx=self.ctx)
            fits = res.fits.tolist()  # one read of each telemetry tensor
            iters, converged = res.n_iters.tolist(), res.converged.tolist()
            if self.ctx.torch_device.type == "cuda":
                torch.cuda.synchronize(self.ctx.torch_device)
            execute_s = time.perf_counter() - t0
            observed = _otrace.should_record(self.ctx.observe)
            if observed:
                _otrace.record_event("serve_bucket", bucket=key, batch=len(reqs),
                                     padded_shape=list(padded), rank=rank, cold=cold,
                                     execute_s=execute_s)
            for b, r in enumerate(reqs):
                out[r.request_id] = sr = ServeResult(
                    request_id=r.request_id,
                    factors=[f[b, : r.x.shape[k]] for k, f in enumerate(res.factors)],
                    weights=res.weights[b],
                    fit=float(fits[b]),
                    n_iters=int(iters[b]),
                    converged=bool(converged[b]),
                    bucket=key,
                    batch=len(reqs),
                    queue_s=t0 - r.enqueued_at,
                    execute_s=execute_s,
                    cold=cold,
                )
                if observed:
                    _otrace.record_event(
                        "serve_request", request_id=r.request_id, bucket=key, batch=sr.batch,
                        shape=list(r.x.shape), rank=rank, queue_s=sr.queue_s,
                        execute_s=sr.execute_s, fit=sr.fit, n_iters=sr.n_iters,
                        converged=sr.converged, cold=cold)
        return out


def _parse_shape(s: str) -> tuple[int, ...]:
    return tuple(int(t) for t in s.split("x"))


def main(argv: list[str] | None = None) -> int:
    """Synthetic-workload demo: enqueue ``--requests`` random low-rank
    tensors (extents jittered below ``--shape``, so several element shapes
    share each bucket), flush once, print bucket stats and req/s."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve", description=__doc__)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--shape", type=_parse_shape, default=(12, 10, 8))
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--pad-to", type=int, default=DEFAULT_PAD_TO)
    ap.add_argument("--cache-dir", default=None,
                    help="directory the kernels are built into and loaded from (warm starts)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..core.tensor import random_low_rank_tensor

    ctx = ExecutionContext.create("auto", compilation_cache=args.cache_dir, device=args.device)
    server = DecompositionServer(ctx, pad_to=args.pad_to, n_iters=args.iters, tol=args.tol)
    gen = torch.Generator(device=ctx.torch_device).manual_seed(args.seed)
    for i in range(args.requests):
        # jitter extents down by up to pad_to - 1: one bucket, mixed shapes
        jit = torch.randint(0, max(args.pad_to, 2), (len(args.shape),), generator=gen,
                            device=ctx.torch_device).tolist()
        shape = tuple(max(int(s) - int(j), 2) for s, j in zip(args.shape, jit))
        x, _ = random_low_rank_tensor(gen, shape, args.rank)
        server.submit(x, args.rank, request_id=f"req{i}")
    t0 = time.perf_counter()
    results = server.flush()
    dt = time.perf_counter() - t0
    n_buckets = len({r.bucket for r in results.values()})
    print(f"served {len(results)} request(s) in {dt * 1e3:.1f} ms "
          f"({len(results) / dt:.1f} req/s) across {n_buckets} bucket(s)")
    for rid in sorted(results, key=lambda r: int(r[3:])):
        r = results[rid]
        print(f"  {rid}: fit={r.fit:.4f} iters={r.n_iters} converged={r.converged} "
              f"batch={r.batch} {'cold' if r.cold else 'warm'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
