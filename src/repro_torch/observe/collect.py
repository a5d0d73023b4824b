"""The Hopper kernels' launches, as their wrappers report them to an
active collector.

A kernel launched through ``ctypes`` never passes PyTorch's dispatcher, so
no ``TorchDispatchMode`` sees it. Each wrapper therefore reports its own
launch here: the kernel's name, the plan it ran under, the bytes of its
operands (read) and of its result (written), a split-K workspace
included, and the dtype of the buffer it writes. On a CPU tensor a wrapper runs its plain version and reports the
launches the card would make for the same call (the plan it would choose
on an H100, the split-K reduction where that plan splits), with the plain
version's own operations kept out of any count (:func:`quiet`). So a
count is the same on the CPU and on the card.

Two collectors read the reports: a dispatch span (which plan ran, for the
span's ``plan`` and ``kernel_modeled_bytes``) and the bounds audit (the
bytes). With no collector a wrapper pays one check of :data:`SINKS`.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass


@dataclass(frozen=True)
class Launch:
    """One kernel launch: ``plan`` is None for the split-K reduction;
    ``written_dtype`` the dtype of the buffer it writes (``"float32"`` for
    every kernel but ``ssd_intra``, which writes X's)."""

    name: str
    plan: object
    read_bytes: int
    written_bytes: int
    written_dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        return self.read_bytes + self.written_bytes


#: The active collectors (lists of :class:`Launch`), innermost last.
SINKS: list[list[Launch]] = []
_QUIET = [0]


def report(name: str, plan, read_bytes: int, written_bytes: int,
           written_dtype: str = "float32") -> None:
    """Hand one launch to every active collector."""
    launch = Launch(name, plan, int(read_bytes), int(written_bytes), written_dtype)
    for sink in SINKS:
        sink.append(launch)


def report_split(name: str, plan, read_bytes: int, out_bytes: int, splits: int,
                 other_written: int = 0) -> None:
    """A CPU tensor's stand-in for a kernel launch that writes ``splits``
    fp32 slabs of its ``out_bytes`` output (the output itself when 1), plus
    ``other_written`` bytes of other results, and for the split-K
    reduction that sums the slabs."""
    ws = out_bytes * splits if splits > 1 else out_bytes
    report(name, plan, read_bytes, ws + other_written)
    if splits > 1:
        report("splitk_reduce", None, ws, out_bytes)


def stand_in(plain, report_launches):
    """``plain()`` for a CPU tensor; with a collector active, run quietly
    and then ``report_launches()``: the launches the card would make."""
    if not SINKS:
        return plain()
    with quiet():
        out = plain()
    report_launches()
    return out


def detach(sink: list[Launch]) -> None:
    """Remove ``sink`` from :data:`SINKS` (by identity: two empty sinks are
    equal lists)."""
    del SINKS[next(i for i, s in enumerate(SINKS) if s is sink)]


@contextmanager
def collecting():
    """Collect the launches made inside the block into the yielded list."""
    sink: list[Launch] = []
    SINKS.append(sink)
    try:
        yield sink
    finally:
        detach(sink)


@contextmanager
def quiet():
    """A plain version standing in for a kernel: the operations inside are
    not the kernel's traffic, so the op-boundary count skips them."""
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


def is_quiet() -> bool:
    return _QUIET[0] > 0


def dtype_name(t) -> str:
    """``"float32"`` for a float32 tensor: the name :class:`Launch` keeps."""
    return str(t.dtype).removeprefix("torch.")


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements (a tensor the batch shares counts once)."""
    return sum(t.numel() * t.element_size() for t in tensors)
