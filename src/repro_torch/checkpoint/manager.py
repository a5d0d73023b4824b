"""Checkpoint manager, the port of ``repro/checkpoint/manager.py``, on the
reference's on-disk format, so either package reads what the other wrote:

* **Atomicity**: write to ``step_<n>.tmp/``, fsync, rename to ``step_<n>/``
  — a crash mid-save never corrupts the latest checkpoint.
* **Integrity**: ``manifest.json`` holds per-array shapes/dtypes and the
  reference's sampled checksum (:func:`_checksum`); restore verifies it
  before trusting the arrays.
* **bf16**: numpy has no bfloat16 without ``ml_dtypes``, so a bf16 tensor
  is written as its ``uint16`` view and named in the manifest's
  ``bf16_keys``, as the reference writes it; it is read back through
  ``torch.int16``.
* **Async save**: :meth:`CheckpointManager.save_async` copies every tensor
  to host memory now (a copy even of a CPU tensor, since the optimizer
  updates the state in place) and writes on a background thread.
* **GC**: keep the last k.

A state is serialized by flattening it with path strings, as the
reference flattens its pytrees: a mapping's keys, a named tuple's field
names, a sequence's indices, and a module's parameter names split at the
dots; None holds nothing.

**Elastic restore**: :func:`restore_latest` with ``mesh=`` and
``spec_tree=`` lays each restored leaf out on ``mesh`` by its spec
(``distribute_tensor``), whatever mesh saved it. A state of DTensors is
saved as its whole arrays, the files the same as an unsharded save's, so
checkpoints stay mesh-agnostic. Every rank gathers (``full_tensor()``) on
the calling thread, before the writer thread starts (a collective there
would deadlock), and only rank 0 writes; a restore on a mesh waits at a
barrier until rank 0's write is done.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.sharding import Sharding, full


# --------------------------------------------------------------------------
# state <-> flat dict
# --------------------------------------------------------------------------

def _flatten(tree, prefix: tuple[str, ...] = ()) -> dict[str, Any]:
    if tree is None:
        return {}
    if isinstance(tree, nn.Module):
        return {"/".join(prefix + tuple(name.split("."))): p
                for name, p in tree.named_parameters()}
    if isinstance(tree, Mapping):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {"/".join(prefix): tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _flat_specs(template, specs, prefix: tuple[str, ...] = ()) -> dict[str, tuple]:
    """``specs`` (the structure of ``template``, a spec at each tensor leaf
    and, for a module, a mapping by parameter name) by the keys
    :func:`_flatten` gives ``template``'s leaves."""
    if template is None or specs is None:
        return {}
    if isinstance(template, nn.Module):
        return {"/".join(prefix + tuple(name.split("."))): specs[name]
                for name, _ in template.named_parameters()}
    if isinstance(template, Mapping):
        items = ((str(k), v, specs[k]) for k, v in template.items())
    elif isinstance(template, tuple) and hasattr(template, "_fields"):
        items = zip(template._fields, template, specs)
    elif isinstance(template, (list, tuple)):
        items = ((str(i), v, s) for i, (v, s) in enumerate(zip(template, specs)))
    else:
        return {"/".join(prefix): specs}
    flat: dict[str, tuple] = {}
    for k, v, s in items:
        flat.update(_flat_specs(v, s, prefix + (k,)))
    return flat


def _leaf(template, array: torch.Tensor) -> torch.Tensor:
    """A restored leaf, on the template's device where it is a tensor (a
    leaf already laid out on a mesh stays there)."""
    from torch.distributed.tensor import DTensor

    if isinstance(template, torch.Tensor) and not isinstance(array, DTensor):
        return array.to(template.device)
    return array


def _unflatten_into(template, flat: Mapping[str, torch.Tensor], prefix: tuple[str, ...] = ()):
    def get(key: str):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return flat[key]

    if template is None:
        return None
    if isinstance(template, nn.Module):
        # a copy of the module whose parameters are the restored arrays
        memo = {}
        for name, p in template.named_parameters():
            a = _leaf(p, get("/".join(prefix + tuple(name.split(".")))))
            memo[id(p)] = nn.Parameter(a, requires_grad=p.requires_grad and a.is_floating_point())
        return copy.deepcopy(template, memo)
    if isinstance(template, Mapping):
        return {k: _unflatten_into(v, flat, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten_into(v, flat, prefix + (f,))
                                for f, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, prefix + (str(i),))
                              for i, v in enumerate(template))
    return _leaf(template, get("/".join(prefix)))


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array the file holds (bf16 as its uint16 view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _is_bf16(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def _host_copy(leaf):
    """A copy in host memory that no later in-place update reaches; a
    DTensor's whole value (gathered: every rank calls this)."""
    if isinstance(leaf, torch.Tensor):
        return full(leaf.detach()).to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or a
    process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def _checksum(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        a = arrays[k]
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        # sampled content hash (hashing TBs fully would serialize the save)
        flat = a.reshape(-1)
        probe = flat[:: max(1, flat.size // 4096)]
        h.update(np.ascontiguousarray(probe).tobytes())
    return h.hexdigest()


def _write(directory: str, step: int, flat: dict[str, Any], extra: dict | None) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    bf16_keys = [k for k, v in flat.items() if _is_bf16(v)]
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "checksum": _checksum(arrays),
        "bf16_keys": bf16_keys,
        "extra": extra or {},
        "leaves": {
            k: {"shape": list(np.shape(a)), "dtype": str(a.dtype)}
            for k, a in arrays.items()
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None) -> str | None:
    """Synchronous atomic save of a state at ``step`` (its DTensors
    gathered on every rank, written by rank 0 alone: the path it wrote, or
    None on the other ranks)."""
    host = {k: _host_copy(v) for k, v in _flatten(tree).items()}
    return _write(directory, step, host, extra) if _writer() else None


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def restore_latest(directory: str, template, mesh=None, spec_tree=None,
                   step: int | None = None):
    """Restore into ``template``'s structure (each tensor on its template
    leaf's device, in the dtype it was saved in; a module as a copy of the
    template holding the restored parameters), re-laid-out onto ``mesh``
    per ``spec_tree`` (elastic: the mesh need not match the saving mesh;
    a leaf with a spec becomes a DTensor on ``mesh``'s device). Returns
    (step, tree), or (None, None) when no checkpoint exists."""
    steps = list_steps(directory)
    if not steps:
        return None, None
    step = step if step is not None else steps[-1]
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    if _checksum(arrays) != manifest["checksum"]:
        raise IOError(f"checkpoint {path} failed integrity check")
    bf16 = set(manifest.get("bf16_keys", []))
    flat = {k: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if k in bf16
                else torch.from_numpy(a)) for k, a in arrays.items()}
    if mesh is not None:
        sh = Sharding(mesh=mesh)
        for k, spec in _flat_specs(template, spec_tree).items():
            flat[k] = sh.place(flat[k].to(mesh.device_type), spec)
    return manifest["step"], _unflatten_into(template, flat)


class CheckpointManager:
    """Async save + keep-k GC around the primitives above."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = list_steps(directory)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, extra: dict | None = None):
        """Snapshot to host now (DTensors gathered here, on the calling
        thread, by every rank); write + GC on a background thread, on rank
        0 alone."""
        self.wait()
        host = {k: _host_copy(v) for k, v in _flatten(tree).items()}
        if not _writer():
            return

        def work():
            _write(self.directory, step, host, extra)
            self.saved_steps = list_steps(self.directory)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, extra: dict | None = None):
        if save_checkpoint(self.directory, step, tree, extra) is not None:
            self.saved_steps = list_steps(self.directory)
            self._gc()

    def _gc(self):
        steps = list_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s}"),
                ignore_errors=True,
            )
        self.saved_steps = list_steps(self.directory)

    def restore_latest(self, template, mesh=None, spec_tree=None):
        """The latest checkpoint, laid out on ``mesh`` by ``spec_tree`` if
        given; on a mesh every rank first waits until rank 0's write is
        done."""
        self.wait()
        if mesh is not None and dist.is_initialized():
            dist.barrier()
        return restore_latest(self.directory, template, mesh=mesh, spec_tree=spec_tree)
