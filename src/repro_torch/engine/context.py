"""ExecutionContext: the one immutable configuration object of the port.

Counterpart of ``repro.engine.context.ExecutionContext`` for this slice:
backend, :class:`~.plan.Memory`, dtype policy, and the device the entry
points run on. It is validated once, eagerly (``__post_init__``), and
round-trips through JSON under its own schema tag.

Backends: ``einsum`` (``torch.einsum``), ``blocked_host`` (Algorithm 2 as a
host-level einsum) and ``cuda`` (the hand-written Hopper kernels). On a
CUDA tensor ``cuda`` launches the kernels or raises; only a tensor that
lies on the CPU takes the kernels' plain versions.

The device defaults to ``"cuda"``: a context built on a host without CUDA
raises unless the caller asks for ``device="cpu"``.

Tuning (``backend="auto"``, ``tune``), the distributed path and the
observability layer come with later slices and are rejected here with a
message that names the slice.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Mapping

import torch

from .plan import Memory

SCHEMA = "repro_torch.ExecutionContext/1"

VALID_BACKENDS = ("einsum", "blocked_host", "cuda")
_LATER = {
    "auto": "backend='auto' resolves through the autotuner, which comes with the "
            "tuning slice (ROADMAP Queue 1 item 9)",
    "pallas": "the TPU kernels' counterparts here are backend='cuda'",
    "tune": "tune=True comes with the tuning slice (ROADMAP Queue 1 item 9)",
    "distributed": "the distributed drivers come with their slice (ROADMAP Queue 1 item 12)",
    "observe": "observe=True comes with the observability slice (ROADMAP Queue 1 item 10)",
}


def check_backend(backend: str) -> None:
    """The backend validator: lists the valid values, and names the slice
    that brings a reference backend this port does not have yet."""
    if backend in _LATER:
        raise ValueError(f"backend={backend!r} is not available: {_LATER[backend]}")
    if backend not in VALID_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {VALID_BACKENDS}")


def dtype_name(dtype: str | torch.dtype) -> str:
    """``torch.bfloat16`` or ``"bfloat16"`` -> ``"bfloat16"`` (validated)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if not isinstance(getattr(torch, str(dtype), None), torch.dtype):
        raise ValueError(f"{dtype!r} is not a torch dtype")
    return str(dtype)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, dtype_name(name))


def check_device(device: str | torch.device, api: str) -> torch.device:
    """The device an entry point runs on: 'cuda' (the default everywhere),
    which raises on a host without CUDA, or 'cpu' when the caller asks."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{api}(device='cuda'): this host has no CUDA device; "
            "pass device='cpu' to run on the host"
        )
    return dev


@dataclass(frozen=True)
class ExecutionContext:
    """The execution environment, as one immutable, hashable value."""

    backend: str = "cuda"
    memory: Memory | None = None
    out_dtype: str | None = None
    compute_dtype: str | None = None
    device: str = "cuda"

    def __post_init__(self):
        check_backend(self.backend)
        if self.memory is not None and not isinstance(self.memory, Memory):
            raise ValueError(
                f"memory must be a repro_torch.Memory (e.g. Memory.h100_smem()), "
                f"got {type(self.memory).__name__}"
            )
        if self.out_dtype is not None:
            object.__setattr__(self, "out_dtype", dtype_name(self.out_dtype))
        if self.compute_dtype is not None:
            name = dtype_name(self.compute_dtype)
            if not torch_dtype(name).is_floating_point:
                raise ValueError(
                    f"compute_dtype must be a float dtype (inputs are cast to it; "
                    f"accumulation stays fp32), got {name!r}"
                )
            object.__setattr__(self, "compute_dtype", name)
        object.__setattr__(self, "device", str(check_device(self.device, "ExecutionContext")))

    @classmethod
    def create(
        cls,
        backend: str = "cuda",
        *,
        memory: Memory | None = None,
        out_dtype: str | torch.dtype | None = None,
        compute_dtype: str | torch.dtype | None = None,
        device: str | torch.device = "cuda",
        tune: bool = False,
        distributed: bool = False,
        observe: bool = False,
    ) -> "ExecutionContext":
        """Build and validate a context. ``tune``, ``distributed`` and
        ``observe`` exist to reject a reference call that sets them."""
        for key, on in (("tune", tune), ("distributed", distributed), ("observe", observe)):
            if on:
                raise ValueError(_LATER[key])
        return cls(
            backend=backend,
            memory=memory,
            out_dtype=None if out_dtype is None else dtype_name(out_dtype),
            compute_dtype=None if compute_dtype is None else dtype_name(compute_dtype),
            device=str(device),
        )

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def check_tensor(self, api: str, *tensors: torch.Tensor | None) -> None:
        """Raise unless every tensor lies on this context's device type:
        the entry points never move data behind the caller's back."""
        for t in tensors:
            if t is not None and t.device.type != self.torch_device.type:
                raise ValueError(
                    f"{api}: tensor on {t.device} but the context runs on {self.device}; "
                    f"move it with .to({self.device!r}) or build the context with "
                    f"device={t.device.type!r}"
                )

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        mem = None
        if self.memory is not None:
            mem = {
                "budget_bytes": self.memory.budget_bytes,
                "lane": self.memory.lane,
                "sublane": self.memory.sublane,
                "itemsize": self.memory.itemsize,
            }
        return {
            "schema": SCHEMA,
            "backend": self.backend,
            "memory": mem,
            "out_dtype": self.out_dtype,
            "compute_dtype": self.compute_dtype,
            "device": self.device,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExecutionContext":
        from ..convert import memory_from_dict  # call-time: convert imports the core

        schema = d.get("schema", SCHEMA)
        if schema != SCHEMA:
            raise ValueError(
                f"unsupported ExecutionContext schema {schema!r} (this build reads {SCHEMA!r})"
            )
        mem = d.get("memory")
        return cls(
            backend=str(d.get("backend", "cuda")),
            memory=memory_from_dict(mem) if mem is not None else None,
            out_dtype=d.get("out_dtype"),
            compute_dtype=d.get("compute_dtype"),
            device=str(d.get("device", "cuda")),
        )

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionContext":
        """Inverse of :meth:`to_json`: ``from_json(ctx.to_json()) == ctx``."""
        return cls.from_dict(json.loads(s))
