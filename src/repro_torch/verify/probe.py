"""The kernel walks held against the kernels on the card: the card-side twin
of :mod:`repro_torch.verify.kernels`.

For a :class:`~repro_torch.verify.kernels.WalkCase`:

* :func:`check_grid` — the launch grid the C launcher takes, from the
  library's own grid function (``repro_*_grid``), equals the mirror's;
* :func:`probe_case` — the case's wrapper on real inputs on the card,
  launched once from the write-probe build of its source
  (``kernels/build.py:write_probe``, every stored element counted) and once
  from the production library: every element of every buffer each launch
  writes counts exactly 1, no store lands outside its buffer (the overflow
  slot counts 0), the buffers are the mirror's, and the two outputs are
  equal bit for bit (the probe adds counting only).

Both need a card and the built libraries; ``chip_smoke.py`` (phase 15)
and the card tests run them. A probe launch counts in no wrapper's
``launches``.
"""

from __future__ import annotations

import math

import torch

from ..engine.plan import H100_SMS
from .kernels import Walk, WalkCase, case_plan, case_walk, library_grid, splitk_walk


def check_grid(case: WalkCase, sms: int = H100_SMS) -> dict:
    """The library's grid for ``case`` beside the mirror's."""
    plan = case_plan(case, sms)
    lib, mirror = library_grid(case, plan, sms), case_walk(case, plan, sms).grid
    return {"kernel": case.wrapper, "label": case.label, "shape": list(case.shape),
            "batch": case.batch, "plan": None if plan is None else repr(plan),
            "library": list(lib), "mirror": list(mirror), "equal": tuple(lib) == tuple(mirror)}


def _dtype(itemsize: int) -> torch.dtype:
    return torch.float32 if itemsize == 4 else torch.bfloat16


def case_inputs(case: WalkCase, device: torch.device, seed: int = 0) -> tuple:
    """Real operands for ``case`` on ``device``, from ``seed``: a batch's
    factors per element, or shared (``case.shared``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(case.itemsize)

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)

    b, w, shape = case.batch, case.wrapper, case.shape
    lead = (b,) if b > 1 else ()

    def mats(sizes, cols):
        return [randn(*(() if case.shared else lead), d, c) for d, c in zip(sizes, cols)]

    if w in ("mttkrp3", "mttkrpn", "fused_pair"):
        return (randn(*lead, *shape), mats(shape[1:], [case.rank] * (len(shape) - 1)))
    if w == "multi_ttm_keep":
        return (randn(*lead, *shape), mats(shape[1:], case.rank))
    if w == "splitk_reduce":
        s, n = shape
        return (randn(s, n, dtype=torch.float32),)
    if w == "mttkrp_partial":
        storage = sum((s - 1) * st for s, st in zip(shape, case.strides)) + case.rank
        base = randn(b * storage)
        node = base.as_strided(
            (*lead, *shape, case.rank),
            ((storage,) if b > 1 else ()) + tuple(case.strides) + (1,))
        return (node, mats(shape[case.nkeep:], [case.rank] * (len(shape) - case.nkeep)))
    if w == "ssd_intra":
        bcn, q, n, h, p = shape
        f32 = torch.float32
        decay = torch.nn.functional.softplus(randn(bcn, q, h, dtype=f32))
        return (randn(bcn, q, n, dtype=f32), randn(bcn, q, n, dtype=f32),
                -0.1 * torch.cumsum(decay, dim=1), torch.nn.functional.softplus(
                    randn(bcn, q, h, dtype=f32)), randn(bcn, q, h, p))
    raise ValueError(f"unknown wrapper {w!r}")


def launch_case(case: WalkCase, plan, inputs: tuple):
    """The case's wrapper on ``inputs`` under ``plan``; its output(s) as a
    tuple."""
    from ..kernels.mttkrp3 import mttkrp3
    from ..kernels.mttkrpn import mttkrpn
    from ..kernels.multi_ttm import multi_ttm_keep
    from ..kernels.partial import mttkrp_partial
    from ..kernels.splitk import splitk_reduce
    from ..kernels.ssd_intra import ssd_intra
    from ..kernels.sweep import fused_pair

    w = case.wrapper
    if w == "mttkrp3":
        x, fs = inputs
        return (mttkrp3(x, fs[0], fs[1], plan=plan),)
    if w == "mttkrpn":
        return (mttkrpn(inputs[0], inputs[1], plan=plan),)
    if w == "fused_pair":
        return fused_pair(inputs[0], inputs[1], plan=plan)
    if w == "multi_ttm_keep":
        return (multi_ttm_keep(inputs[0], inputs[1], plan=plan, batched=case.batch > 1),)
    if w == "mttkrp_partial":
        return (mttkrp_partial(inputs[0], inputs[1], plan=plan, batched=case.batch > 1),)
    if w == "splitk_reduce":
        ws = inputs[0]
        return (splitk_reduce(ws, torch.empty(ws.shape[1:], device=ws.device)),)
    if w == "ssd_intra":
        return (ssd_intra(*inputs, plan=plan),)
    raise ValueError(f"unknown wrapper {w!r}")


def _expected(case: WalkCase, walk: Walk) -> list[list]:
    """The buffers the mirror predicts for each launch the wrapper makes: the
    kernel's, then the split-K reduction's output where the kernel writes a
    workspace of more than one slab."""
    launches = [[b for b in walk.buffers]]
    first = walk.buffers[0]
    if case.wrapper != "splitk_reduce" and first.name.endswith("ws"):
        n = math.prod(first.shape[1:])
        launches.append(list(splitk_walk(n).buffers))
    return launches


def probe_case(case: WalkCase, device: torch.device, seed: int = 0,
               sms: int | None = None) -> dict:
    """Run ``case`` from the probe build and the production library on the
    same inputs and compare the counts with the mirror (see the module
    docstring). Returns the case's record; ``ok`` is whether every check
    held."""
    from ..kernels import build
    from .kernels import wrapper_launches

    sms = sms if sms is not None else torch.cuda.get_device_properties(
        device).multi_processor_count
    plan = case_plan(case, sms)
    walk = case_walk(case, plan, sms)
    inputs = case_inputs(case, device, seed)
    counted = wrapper_launches()
    with build.write_probe() as probe:
        got = launch_case(case, plan, inputs)
    torch.cuda.synchronize(device)
    silent = wrapper_launches() == counted
    want = launch_case(case, plan, inputs)
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    expected = _expected(case, walk)
    checked = overflow = 0
    max_count, min_count = 0, None
    shapes_agree = len(probe.launches) == len(expected)
    for rec, bufs in zip(probe.launches, expected):
        shapes_agree &= [t.numel() for t, _ in rec["buffers"]] == [math.prod(b.shape)
                                                                   for b in bufs]
        for _, counts in rec["buffers"]:
            elems = counts[:-1]
            checked += elems.numel()
            max_count = max(max_count, int(elems.max()))
            lo = int(elems.min())
            min_count = lo if min_count is None else min(min_count, lo)
            overflow += int(counts[-1])
    ok = (shapes_agree and silent and bit_equal and max_count == 1 and min_count == 1
          and overflow == 0)
    record = {
        "kernel": case.wrapper, "label": case.label, "shape": list(case.shape),
        "rank": case.rank if isinstance(case.rank, int) else list(case.rank),
        "itemsize": case.itemsize, "batch": case.batch, "shared": case.shared,
        "plan": None if plan is None else repr(plan), "grid": list(walk.grid),
        "buffers": [[b.to_dict() for b in bufs] for bufs in expected],
        "probe_launches": len(probe.launches), "elements_checked": checked,
        "max_count": max_count, "min_count": min_count, "overflow": overflow,
        "bit_equal": bit_equal, "launches_uncounted": silent, "ok": ok,
    }
    del inputs, got, want, probe
    torch.cuda.empty_cache()
    return record
