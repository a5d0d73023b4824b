"""The SSM's gated norm (``ssm._gated_norm``) on each rank's own channels,
on gloo meshes of host tensors, against JAX's ``repro.models.ssm._gated_norm``:

* **the values**: on ``(2, 2)`` and ``(2, 4)`` meshes the norm of ``y *
  silu(z)`` over ``d_inner`` (split over tp, the rows over dp, as
  ``apply_ssm`` lays them out), and its three gradients (y, z and
  ``norm_scale``) under one upstream gradient, within 1e-5 relative
  (max |d| / max |ref|) of JAX's output and ``jax.vjp``'s, on numpy inputs
  from a seed, in fp32; for the prefill's and train step's (B, S,
  d_inner) and for the decode step's (B, d_inner);
* **the collectives**: under ``CommDebugMode``, the forward and the
  backward each run one all-reduce and nothing else, and its operand (a
  dispatch mode records the local shapes) is each rank's (B_local, S, 1)
  fp32 statistic (B_local, 1 for the decode form): no all-gather and no
  reduce-scatter of a (B, S, d_inner) operand;
* **the earlier bits**: on a ``(1, 1)`` mesh the output and the gradients
  are bit-equal (``torch.equal``) to the unsharded norm's.

Each mesh is one gloo group (``torch.distributed`` over a ``FileStore``;
this file, run as a script, is the worker).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESHES = ((1, 1), (2, 2), (2, 4))
TIMEOUT = 120
TOL = 1e-5
B, S, D = 4, 8, 64
#: The input forms: apply_ssm's (B, S, d_inner), apply_ssm_decode's (B, d_inner).
FORMS = {"seq": (B, S, D), "token": (B, D)}


def _inputs(form: str) -> dict:
    """y, z, the scale and the upstream gradient, from a seed."""
    rng = np.random.default_rng(71)
    shape = FORMS[form]
    return {"y": rng.standard_normal(shape, dtype=np.float32),
            "z": rng.standard_normal(shape, dtype=np.float32),
            "scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            "g": rng.standard_normal(shape, dtype=np.float32)}


# --------------------------------------------------------------------------
# The worker: one rank of a gloo group
# --------------------------------------------------------------------------

def _collectives():
    """A dispatch mode that records each functional collective's name and
    its operand's local shape and dtype (the ops the dry run counts as
    collectives)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.dryrun import COLLECTIVE_KINDS

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            namespace, name = func._schema.name.split("::")
            if namespace == "_c10d_functional" and name in COLLECTIVE_KINDS:
                self.seen.append((name, tuple(args[0].shape), str(args[0].dtype)))
            return func(*args, **(kwargs or {}))

    return Collectives()


def case(mesh, form: str) -> dict:
    """The norm sharded and unsharded on the same inputs: the sharded
    output and gradients whole, each pass's collectives, and on the
    unsharded path the same."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.sharding import NULL, Sharding, full, replicating
    from repro_torch.models.ssm import _gated_norm

    sh = Sharding(mesh=mesh)
    arrays = {k: torch.from_numpy(v) for k, v in _inputs(form).items()}
    lead = (None,) * (len(FORMS[form]) - 2)

    def run(sh):
        y, z, g = (sh.constrain(arrays[k].clone(), "dp", *lead, "tp") for k in ("y", "z", "g"))
        scale = sh.constrain(arrays["scale"].clone(), None)
        leaves = [t.requires_grad_(True) for t in (y, z, scale)]
        with replicating(sh):
            fwd, fwd_mode = CommDebugMode(), _collectives()
            with fwd, fwd_mode:
                out = _gated_norm(y, z, scale, sh=sh)
            bwd, bwd_mode = CommDebugMode(), _collectives()
            with bwd, bwd_mode:
                grads = torch.autograd.grad(out, leaves, g)
        return {"out": full(out).detach().clone(),
                "grads": [full(t).detach().clone() for t in grads],
                "forward": fwd_mode.seen, "backward": bwd_mode.seen,
                "forward_counts": {str(k): v for k, v in fwd.get_comm_counts().items()},
                "backward_counts": {str(k): v for k, v in bwd.get_comm_counts().items()},
                "rows": y.to_local().shape[0] if sh.mesh is not None else y.shape[0]}

    got, want = run(sh), run(NULL)
    return {"got": got, "unsharded": want, "tp": sh.tp_size}


def worker(rank: int, dp: int, tp: int, store: str, out: str) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, dp * tp), rank=rank,
                            world_size=dp * tp)
    mesh = make_debug_mesh(dp, tp, device_type="cpu")
    result = {form: case(mesh, form) for form in FORMS}
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    tmp = tmp_path_factory.mktemp("mesh_norm")
    env = {**os.environ, "PYTHONPATH": SRC, "GLOO_SOCKET_IFNAME": os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), "OMP_NUM_THREADS": "1"}
    procs = {}
    for dp, tp in MESHES:
        name = f"{dp}x{tp}"
        procs[name] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(r), str(dp), str(tp),
             str(tmp / f"store{name}"), str(tmp / f"{name}.pt")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(dp * tp)]
    bad = []
    try:
        for name, group in procs.items():
            for r, p in enumerate(group):
                out = p.communicate(timeout=TIMEOUT)[0]
                if p.returncode:
                    bad.append(f"{name} rank {r} rc={p.returncode}:\n{out[-4000:]}")
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert not bad, "\n".join(bad)
    return {name: torch.load(tmp / f"{name}.pt", weights_only=False) for name in procs}


@pytest.fixture(scope="module")
def reference():
    """JAX's gated norm and its VJP on each form's inputs: form -> (out,
    [dy, dz, dscale])."""
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import _gated_norm

    out = {}
    for form in FORMS:
        a = {k: jnp.asarray(v) for k, v in _inputs(form).items()}
        value, vjp = jax.vjp(_gated_norm, a["y"], a["z"], a["scale"])
        out[form] = (np.asarray(value), [np.asarray(t) for t in vjp(a["g"])])
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


SHARDED = ["2x2", "2x4"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh", SHARDED)
def test_the_sharded_norm_is_jaxs(runs, reference, mesh, form):
    got = runs[mesh][form]
    assert got["tp"] > 1
    want, _ = reference[form]
    assert _rel(got["got"]["out"].numpy(), want) <= TOL


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh", SHARDED)
def test_the_sharded_norms_gradients_are_jaxs(runs, reference, mesh, form):
    got = runs[mesh][form]["got"]["grads"]
    _, want = reference[form]
    for name, g, w in zip(("y", "z", "scale"), got, want):
        assert _rel(g.numpy(), w) <= TOL, name


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh", SHARDED)
def test_each_pass_only_sums_the_rows_statistic(runs, mesh, form):
    got = runs[mesh][form]["got"]
    stat = (got["rows"],) + FORMS[form][1:-1] + (1,)
    for part in ("forward", "backward"):
        counts = got[f"{part}_counts"]
        # one all-reduce (the op's name as this torch prints it), nothing else
        assert [k.rsplit(".", 1)[-1] for k in counts] == ["all_reduce"], (part, counts)
        assert sum(counts.values()) == 1, (part, counts)
        assert got[part] == [("all_reduce", stat, "torch.float32")], (part, got[part])


@pytest.mark.parametrize("form", FORMS)
def test_one_by_one_mesh_keeps_the_unsharded_bits(runs, form):
    got = runs["1x1"][form]
    assert got["tp"] == 1
    assert torch_equal(got["got"]["out"], got["unsharded"]["out"])
    for g, w in zip(got["got"]["grads"], got["unsharded"]["grads"]):
        assert torch_equal(g, w)


@pytest.mark.parametrize("form", FORMS)
def test_the_unsharded_norm_is_jaxs(runs, reference, form):
    got = runs["1x1"][form]["unsharded"]
    want, grads = reference[form]
    assert got["forward"] == got["backward"] == []
    assert _rel(got["out"].numpy(), want) <= TOL
    for g, w in zip(got["grads"], grads):
        assert _rel(g.numpy(), w) <= TOL


def torch_equal(a, b) -> bool:
    import torch

    return torch.equal(a, b)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
