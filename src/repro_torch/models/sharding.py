"""Sharding policy: logical-axis resolution and activation constraints on
DTensor. The port of ``repro/models/sharding.py``.

Logical axes:
  'dp'   data parallel      -> ('pod', 'data') multi-pod, ('data',) single
  'fsdp' param/opt sharding -> same mesh axes as dp (ZeRO over the DP group)
  'tp'   tensor parallel    -> 'model'
  'sp'   sequence/context   -> 'model' (shares the model axis; used for
                               attention in archs whose head counts don't
                               divide the TP degree, and for long decode
                               KV caches)

Per-arch attention policy:
  'head_tp'  shard q/kv heads over tp (requires n_heads % tp == 0)
  'context'  shard the sequence over tp for attention math (heads intact)

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(:mod:`repro_torch.launch.mesh`). A spec is the port's stand-in for
``jax.sharding.PartitionSpec``: a tuple with one entry per tensor dim, each
None, a mesh-axis name or a tuple of names, so that it equals
``tuple(PartitionSpec(...))`` of the reference. :meth:`Sharding.placements`
turns it into DTensor placements, and :meth:`Sharding.constrain` places a
tensor by it: where XLA's ``with_sharding_constraint`` is a hint to the
partitioner, ``constrain`` moves the data then and there (a
``redistribute`` of a DTensor, a ``distribute_tensor`` of a plain tensor).

The policy object is explicit (no global state): the models take it as the
keyword ``sh``; :data:`NULL` (mesh=None) turns every constraint into a
no-op, so the unsharded paths run exactly as without it.
"""

from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass
from typing import Any, Mapping

import torch
from torch import nn

from .config import ArchConfig

#: The port's PartitionSpec: one entry a tensor dim (None, an axis name or
#: a tuple of axis names).
Spec = tuple


@dataclass(frozen=True)
class Sharding:
    mesh: Any = None            # a DeviceMesh with named dims, or None
    dp: tuple[str, ...] = ("data",)
    tp: str | None = "model"
    attn: str = "head_tp"       # head_tp | context
    moe: str = "expert"         # expert | ffn
    decode_cache: str = "seq"   # seq | heads
    shard_batch: bool = True    # False for global_batch < dp (long_500k)
    sp_activations: bool = False  # Megatron-SP: shard layer-boundary
                                  # activations over 'sp' (seq)
    moe_dispatch: str = "replicated"  # replicated | dp: sharding of the
                                      # (E, cap, D) dispatch buffers along cap

    # ---------------------------------------------------------------- axes
    def _resolve(self, dim) -> object:
        if dim is None:
            return None
        if isinstance(dim, (tuple, list)):
            out = []
            for d in dim:
                r = self._resolve(d)
                if r is None:
                    continue
                out.extend(r if isinstance(r, tuple) else (r,))
            return tuple(out) if out else None
        if dim == "dp":
            if not self.shard_batch:
                return None
            return self.dp if len(self.dp) > 1 else self.dp[0]
        if dim == "fsdp":
            return self.dp if len(self.dp) > 1 else self.dp[0]
        if dim in ("tp", "sp"):
            return self.tp
        raise ValueError(f"unknown logical axis {dim!r}")

    def spec(self, *dims) -> Spec:
        return tuple(self._resolve(d) for d in dims)

    def axis_size(self, name: str) -> int:
        """The size of the mesh's dim ``name``."""
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    def fit_spec(self, shape, spec: Spec) -> Spec:
        """Drop trailing mesh axes per dim until the dim size divides the
        sharding (small models on big meshes: whisper's 384-wide dims can't
        split 256 ways — back off to the largest feasible prefix)."""
        if self.mesh is None:
            return spec
        out = []
        for size, part in zip(shape, tuple(spec) + (None,) * len(shape)):
            if part is None:
                out.append(None)
                continue
            axes = list(part) if isinstance(part, tuple) else [part]
            while axes:
                if size % math.prod(self.axis_size(a) for a in axes) == 0:
                    break
                axes.pop()
            out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
        return tuple(out)

    def placements(self, spec: Spec) -> tuple:
        """The DTensor placements of ``spec`` on the mesh: ``Shard(d)`` on
        each mesh dim that tensor dim ``d`` is split over, ``Replicate()``
        on every other. A tensor dim over several mesh dims is split over
        them in the mesh's order (``Shard(d)`` on each, as
        ``PartitionSpec(('a', 'b'))`` splits it); a tuple out of that order
        would need a strided shard, which no spec of the reference asks
        for: ``ValueError``."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(names)
        for d, part in enumerate(spec):
            if part is None:
                continue
            axes = part if isinstance(part, tuple) else (part,)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are out of the "
                                 f"mesh's order {tuple(names)}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def named(self, *dims) -> tuple | None:
        """The placements of ``spec(*dims)`` (the reference's
        ``NamedSharding``), or None without a mesh."""
        if self.mesh is None:
            return None
        return self.placements(self.spec(*dims))

    def place(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """``x`` as a DTensor laid out by ``fit_spec(x.shape, spec)``; ``x``
        itself without a mesh. A plain ``x`` is the whole value on every
        rank (as one host array is to ``jax.device_put``): each rank keeps
        its own shard of it, with no copy sent between ranks."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, distribute_tensor

        pl = self.placements(self.fit_spec(x.shape, spec))
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == pl else x.redistribute(self.mesh, pl)
        return distribute_tensor(x, self.mesh, pl, src_data_rank=None)

    def constrain(self, x: torch.Tensor, *dims) -> torch.Tensor:
        """``x`` laid out by the logical ``dims`` (``x`` itself, the same
        object, without a mesh)."""
        if self.mesh is None:
            return x
        return self.place(x, self.spec(*dims))

    def split_dims(self, shape, spec: Spec, dim: int) -> tuple[int, ...]:
        """The mesh dims, in the mesh's order, that split tensor dim ``dim``
        of a tensor of ``shape`` laid out by ``spec`` (fitted to it); none
        without a mesh."""
        if self.mesh is None:
            return ()
        part = self.fit_spec(shape, spec)[dim]
        axes = () if part is None else part if isinstance(part, tuple) else (part,)
        return tuple(self.mesh.mesh_dim_names.index(a) for a in axes)

    def shard_index(self, dims: tuple[int, ...]) -> int:
        """This rank's shard, of ``prod(sizes of dims)``, of a tensor dim
        split over the mesh dims ``dims`` (0 for none)."""
        coord = self.mesh.get_coordinate() if dims else None
        index = 0
        for d in dims:
            index = index * self.mesh.size(d) + coord[d]
        return index

    # ------------------------------------------------------------- helpers
    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        return self.axis_size(self.tp)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.axis_size(a) for a in self.dp)


NULL = Sharding(mesh=None)


def attention_policy(cfg: ArchConfig, tp_size: int) -> str:
    """head_tp when the TP degree divides the head count, else context
    parallelism (see module docstring)."""
    if tp_size <= 1:
        return "head_tp"
    return "head_tp" if cfg.n_heads % tp_size == 0 else "context"


def moe_policy(cfg: ArchConfig, tp_size: int) -> str:
    """Expert parallelism when experts divide TP, else TP within experts."""
    if cfg.n_experts and cfg.n_experts % max(tp_size, 1) == 0:
        return "expert"
    return "ffn"


def make_policy(
    cfg: ArchConfig,
    mesh,
    dp: tuple[str, ...] = ("data",),
    tp: str | None = "model",
    sp_activations: bool | None = None,
) -> Sharding:
    if mesh is None:
        return NULL
    tp_size = mesh.size(mesh.mesh_dim_names.index(tp)) if tp else 1
    if sp_activations is None:
        # SSD's chunk scan needs the full local sequence; attention-family
        # archs take the Megatron-SP boundary for free
        sp_activations = cfg.family not in ("ssm", "hybrid")
    return Sharding(
        mesh=mesh,
        dp=dp,
        tp=tp,
        attn=attention_policy(cfg, tp_size),
        moe=moe_policy(cfg, tp_size),
        sp_activations=sp_activations,
    )


# --------------------------------------------------------------------------
# running on DTensors
# --------------------------------------------------------------------------

@contextlib.contextmanager
def replicating(sh: Sharding):
    """Under a mesh, plain tensors that meet DTensors (masks from
    ``torch.arange``, zeros that start a sum, positions) count as
    replicated, as constants are in a jitted program; re-entrant. A
    backward through a sharded forward runs inside it too. Without a mesh
    it does nothing."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    if sh.mesh is None or dispatcher._allow_implicit_replication:
        yield
        return
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = False


def full(x):
    """A DTensor's whole value as a plain tensor (``full_tensor()``, a
    collective every rank calls); any other value as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def local_map(sh: Sharding, fn, in_specs, out_layouts):
    """``fn`` run on each rank's local shards, as ``shard_map`` runs it:
    input ``i`` laid out by ``in_specs[i]`` (fitted to its shape), each
    output taken as laid out as the input whose index ``out_layouts``
    names for it, replicated where it names None, or as a list of
    placements gives it (a ``Partial`` one: each rank's output a term of
    the sum) (one entry, or a tuple of them for several outputs).
    Differentiable: each gradient comes back laid out as its input, except
    on a mesh dim where the input is replicated and an output split or
    pending a sum: there each rank's gradient is its own share, a partial
    sum (as ``shard_map``'s transpose sums the cotangent of a replicated
    input). Without a mesh, ``fn`` itself."""
    if sh.mesh is None:
        return fn
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map as _local_map

    def run(*args):
        args = tuple(sh.place(a, s) for a, s in zip(args, in_specs))
        ins = tuple(tuple(a.placements) for a in args)
        replicated = (Replicate(),) * sh.mesh.ndim
        many = isinstance(out_layouts, tuple)
        outs = tuple(replicated if i is None else tuple(i) if isinstance(i, list) else ins[i]
                     for i in (out_layouts if many else (out_layouts,)))
        split = [any(isinstance(o[d], (Shard, Partial)) for o in outs)
                 for d in range(sh.mesh.ndim)]
        grads = tuple(tuple(Partial() if split[d] and isinstance(p, Replicate) else p
                            for d, p in enumerate(pl)) for pl in ins)
        # one output's placements are a list: a tuple would read as one a output
        return _local_map(_contiguous_grads(fn), out_placements=outs if many else list(outs[0]),
                          in_placements=ins,
                          in_grad_placements=grads, device_mesh=sh.mesh,
                          redistribute_inputs=False)(*args)

    return run


def reduce_local(sh: Sharding, x: torch.Tensor, op: str, dims: tuple[int, ...]) -> torch.Tensor:
    """In a function :func:`local_map` runs: each rank's ``x`` reduced by
    ``op`` (``"sum"``, ``"max"``) over the mesh dims ``dims``, the result
    on every rank of them. The all-reduce is DTensor's (a ``Partial``
    made ``Replicate``), as every collective of the mesh layer, so the dry
    run's counter and ``CommDebugMode`` see it. ``x`` itself over no dim."""
    if not dims:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate

    replicated = (Replicate(),) * sh.mesh.ndim
    pending = tuple(Partial(op) if d in dims else Replicate() for d in range(sh.mesh.ndim))
    return DTensor.from_local(x, sh.mesh, pending, run_check=False).redistribute(
        sh.mesh, replicated).to_local()


class _SumLocal(torch.autograd.Function):
    """:func:`reduce_local`'s sum; its gradient the same sum of each rank's
    gradient (every rank's summand reaches every rank's result)."""

    @staticmethod
    def forward(ctx, x, sh: Sharding, dims: tuple[int, ...]):
        ctx.sh, ctx.dims = sh, dims
        return reduce_local(sh, x, "sum", dims)

    @staticmethod
    def backward(ctx, g):
        return reduce_local(ctx.sh, g, "sum", ctx.dims), None, None


def sum_local(sh: Sharding, x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """:func:`reduce_local` by ``"sum"``, differentiable: in the backward
    the gradient is summed over the same mesh dims (one all-reduce each
    way). ``x`` itself over no dim."""
    return _SumLocal.apply(x, sh, dims) if dims else x


def gather_local(sh: Sharding, x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """In a function :func:`local_map` runs: every rank's ``x`` over the
    mesh dims ``dims``, stacked on a new leading dim in the order of
    :meth:`Sharding.shard_index` (an all-gather, DTensor's)."""
    if not dims:
        return x[None]
    from torch.distributed.tensor import DTensor, Replicate, Shard

    split = tuple(Shard(0) if d in dims else Replicate() for d in range(sh.mesh.ndim))
    return DTensor.from_local(x[None], sh.mesh, split, run_check=False).redistribute(
        sh.mesh, (Replicate(),) * sh.mesh.ndim).to_local()


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(fn):
    """``fn`` on local shards, each input's gradient made contiguous: a
    local gradient comes back as the local backward leaves it (a permuted
    einsum's is transposed), and DTensor, which takes the shard's layout
    from the global one, would then view it where it cannot be viewed."""

    def run(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor) and x.requires_grad
                    else x for x in xs))

    return run


class _GradAs(torch.autograd.Function):
    """The identity, its gradient split as the input is."""

    @staticmethod
    def forward(ctx, x, summed: bool):
        ctx.layout = (x.device_mesh, tuple(x.placements), summed)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        mesh, placements, summed = ctx.layout
        # a pending sum stays pending (summing here would change the order),
        # unless asked for; an input pending a sum takes its gradient whole,
        # as DTensor gives it
        want = tuple(p if p.is_partial() and not summed else Replicate() if q.is_partial() else q
                     for p, q in zip(g.placements, placements))
        return (g if tuple(g.placements) == want else g.redistribute(mesh, want)), None


def grad_as_input(x: torch.Tensor, summed: bool = False) -> torch.Tensor:
    """``x``, its gradient split as ``x`` is (a partial sum left pending,
    or with ``summed`` summed there). A DTensor's gradient comes back split
    as the backward's sharding rules pick; where a view's backward then
    reshapes it (a flattened weight's gradient into its heads, a product's
    into (batch x sequence) rows), a split that tp does not divide evenly,
    or one over the sequence, fails. Without ``summed`` only data moves, no
    sum: the values are the same bits. A plain tensor comes back as it
    is."""
    from torch.distributed.tensor import DTensor

    return _GradAs.apply(x, summed) if isinstance(x, DTensor) and x.requires_grad else x


def distribute_tree(tree, spec_tree, sh: Sharding):
    """``tree`` laid out by ``spec_tree`` (the same structure, a spec at
    each tensor leaf): each tensor placed by its spec (:meth:`Sharding.place`),
    a leaf already so placed kept as it is. A module comes back as a copy
    whose parameters are the placed tensors (the module itself where every
    parameter already is), its ``spec_tree`` a mapping by parameter name.
    Without a mesh, ``tree`` itself."""
    if sh.mesh is None or tree is None:
        return tree
    if isinstance(tree, nn.Module):
        memo = {id(p): nn.Parameter(sh.place(p.detach(), spec_tree[name]),
                                    requires_grad=p.requires_grad)
                for name, p in tree.named_parameters() if not _placed(p, spec_tree[name], sh)}
        return copy.deepcopy(tree, memo) if memo else tree
    if isinstance(tree, torch.Tensor):
        return sh.place(tree, spec_tree)
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, spec_tree[k], sh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(v, s, sh) for v, s in zip(tree, spec_tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, sh) for v, s in zip(tree, spec_tree))
    return tree


def _placed(x: torch.Tensor, spec: Spec, sh: Sharding) -> bool:
    """Whether ``x`` is a DTensor on the policy's mesh laid out by ``spec``."""
    from torch.distributed.tensor import DTensor

    return (isinstance(x, DTensor) and x.device_mesh == sh.mesh
            and tuple(x.placements) == sh.placements(sh.fit_spec(x.shape, spec)))
