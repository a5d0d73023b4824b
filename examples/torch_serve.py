"""Decomposition as a service, on the PyTorch/CUDA port: the batched engine
and the request queue.

The steps of ``examples/serve.py``:

1. The batched engine: ``repro_torch.mttkrp`` with a leading batch axis is
   one kernel launch for B tensors (the same answer as a loop), and
   ``repro_torch.cp_als_batched`` runs B decompositions in one sweep with
   per-element convergence.
2. The server: ``DecompositionServer`` buckets mixed-shape requests by
   tune-cache key, pads within each bucket, and runs one batched call a
   bucket.
3. Warm starts: a context with ``compilation_cache=<dir>`` builds the
   kernels into that directory, so the next process serving the same
   buckets loads them instead of running ``nvcc``.

    PYTHONPATH=src python examples/torch_serve.py [--device cpu]
    REPRO_EX_TINY=1 PYTHONPATH=src python examples/torch_serve.py   # CI smoke
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

import repro_torch
from repro_torch.core.tensor import random_low_rank_tensor
from repro_torch.launch.serve import DecompositionServer


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args().device
    tiny = os.environ.get("REPRO_EX_TINY") == "1"
    dims, rank = ((10, 8, 6) if tiny else (20, 16, 12)), 3
    batch = 3 if tiny else 6
    n_iters = 4 if tiny else 12
    ctx = repro_torch.ExecutionContext.create("cuda", device=device)

    # 1. the batched engine path: one launch, B answers
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch,) + dims, generator=gen, device=device)
    factors = [torch.randn((batch, d, rank), generator=gen, device=device) for d in dims]
    batched = repro_torch.mttkrp(x, factors, 0, ctx=ctx)  # leading B axis -> batched
    looped = torch.stack([repro_torch.mttkrp(x[b], [f[b] for f in factors], 0, ctx=ctx)
                          for b in range(batch)])
    print(f"batched MTTKRP over B={batch}: max |batched - looped| = "
          f"{float((batched - looped).abs().max()):.2e}")
    res = repro_torch.cp_als_batched(x, rank, n_iters=n_iters, tol=1e-4, ctx=ctx)
    print(f"cp_als_batched: fits={[f'{float(f):.3f}' for f in res.fits]} "
          f"iters={[int(i) for i in res.n_iters]}")

    # 2. the serving layer: mixed shapes, one batched call a bucket
    with tempfile.TemporaryDirectory() as cache_dir:
        # 3. warm starts: the kernels are built into cache_dir
        ctx = repro_torch.ExecutionContext.create("auto", device=device,
                                                  compilation_cache=cache_dir)
        server = DecompositionServer(ctx, n_iters=n_iters, tol=1e-4)
        for i in range(batch):
            shape = tuple(d - i for d in dims)  # jitter: the same bucket
            t, _ = random_low_rank_tensor(torch.Generator(device=device).manual_seed(10 + i),
                                          shape, rank)
            server.submit(t, rank, request_id=f"req{i}")
        results = server.flush()
        buckets = {r.bucket for r in results.values()}
        print(f"served {len(results)} mixed-shape requests in {len(buckets)} bucket(s):")
        for rid in sorted(results):
            r = results[rid]
            print(f"  {rid}: shape->crop fit={r.fit:.4f} iters={r.n_iters} batch={r.batch} "
                  f"{'cold' if r.cold else 'warm'}")
        n_built = sum(len(fs) for _, _, fs in os.walk(cache_dir))
        print(f"build directory: {n_built} file(s) kept for the next process")


if __name__ == "__main__":
    main()
