"""Build the Hopper kernels with ``nvcc`` at first use and bind them with
``ctypes``.

The sources under ``csrc/`` have a plain C interface, so one ``nvcc`` call
per source builds a shared library (no PyTorch headers): ``mttkrp.cu``
holds the MTTKRP tensor-core kernels and the split-K reduction, ``sweep.cu`` the
fused-sweep pair and the streaming rank-augmented partial contraction,
``multi_ttm.cu`` the kept-mode Multi-TTM of the Tucker path, ``ssd_intra.cu``
the intra-chunk SSD term of the Mamba2 prefill; the first three share the
``cp.async`` ring and tensor-core code of ``ring.cuh``. Each library
goes into ``_build/`` beside this file (listed in ``.gitignore``), named by
a hash of its source, the shared headers and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. :func:`build_all` starts one
``nvcc`` per source at once. A build that fails raises; nothing falls back
to another implementation.

The write probe: :func:`build` takes ``defines``, and ``PROBE_DEFINES``
builds each source once more with ``-DREPRO_WRITE_PROBE``, where every store
of a kernel's result also counts the elements it writes (``csrc/common.cuh:
store_result``). :func:`library` never loads that build. Only
:func:`write_probe` reaches it: inside its block each wrapper launches from
the probe build of its source (:func:`launch_library`) with the buffers it
writes registered, and its launches count nowhere (:func:`count_launch`).
``chip_smoke.py`` and the card tests hold the counts against the Python
mirrors of the kernels' walks (:mod:`repro_torch.verify.kernels`).

That directory is the port's warm start, in place of the reference's XLA
compilation cache: :func:`set_build_dir` (what
``ExecutionContext.ensure_compilation_cache`` calls) points the builds and
loads of this process at another directory, so a second process given the
same directory loads the libraries a first one built instead of running
``nvcc``. A library already loaded in the process stays loaded, from the
directory it was built in (:func:`loaded`): a later redirect affects only
sources not loaded yet, and each build writes its library and report into
one directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_build_dir = BUILD_DIR
#: ``-cudart shared``: the libraries launch through the CUDA runtime that
#: PyTorch loads, so the profiler's runtime tracing sees their launches and
#: attributes each kernel to the ``record_function`` range around it (with
#: the static runtime it records the kernels but links none to a range).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared", "-Xptxas", "-v",
    "-I", str(CSRC),
)
SOURCES = ("mttkrp.cu", "sweep.cu", "multi_ttm.cu", "ssd_intra.cu")
#: The defines of the write-probe build (``csrc/common.cuh``).
PROBE_DEFINES = ("REPRO_WRITE_PROBE",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PLL, _PI = ctypes.POINTER(_LL), ctypes.POINTER(_I)
#: The C entry points of each source: name -> (restype, argtypes).
SIGNATURES = {
    "mttkrp.cu": {
        "repro_mttkrp_tile": (_I, [_I, _I, _I, _PLL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL,
                                   _PLL, _P, _PLL, _P, _P]),
        "repro_splitk_reduce": (_I, [_P, _P, _LL, _I, _P]),
        "repro_mttkrp_smem_bytes": (_LL, [_I, _I, _I, _I, _I, _I]),
        "repro_mttkrp_grid": (_I, [_LL, _I, _I, _I, _I, _I, _PLL]),
        "repro_splitk_reduce_grid": (_I, [_LL, _PLL]),
    },
    "sweep.cu": {
        "repro_fused_pair": (_I, [_I, _I, _PLL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _PLL, _P,
                                  _P, _P]),
        "repro_partial": (_I, [_I, _I, _I, _I, _I, _I, _I, _PLL, _PLL, _I, _PLL, _PLL, _I, _I,
                               _LL, _PLL, _P, _PLL, _P, _P]),
        "repro_fused_pair_smem_bytes": (_LL, [_I, _I, _I, _I, _I, _I]),
        "repro_partial_smem_bytes": (_LL, [_I, _I, _I, _I, _I, _I]),
        "repro_fused_pair_grid": (_I, [_LL, _I, _I, _I, _I, _PLL]),
        "repro_partial_grid": (_I, [_I, _I, _I, _I, _I, _I, _I, _PLL, _I, _PLL, _I, _I, _PLL]),
    },
    "multi_ttm.cu": {
        "repro_multi_ttm": (_I, [_I, _I, _PLL, _PI, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _PLL,
                                 _P, _PLL, _P, _P]),
        "repro_multi_ttm_smem_bytes": (_LL, [_I, _I, _PI, _I, _I, _I, _I]),
        "repro_multi_ttm_grid": (_I, [_I, _PLL, _PI, _I, _I, _I, _I, _PLL]),
    },
    "ssd_intra.cu": {
        "repro_ssd_intra": (_I, [_I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P]),
        "repro_ssd_intra_smem_bytes": (_LL, [_I, _I, _I, _I]),
        "repro_ssd_intra_grid": (_I, [_LL, _I, _I, _I, _I, _PLL]),
    },
}
#: The probe build's own entry point, in every source.
PROBE_SIGNATURES = {"repro_write_probe_set": (_I, [_P, _LL, _I, _P])}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    """The directory this process builds into and loads from."""
    return _build_dir


def set_build_dir(path: str | os.PathLike | None) -> Path:
    """Build into and load from ``path`` from now on (``None``: the default
    ``_build/`` beside this file); returns the directory in use. Libraries
    already loaded stay loaded (:func:`loaded`)."""
    global _build_dir
    _build_dir = BUILD_DIR if path is None else Path(path).expanduser().resolve()
    return _build_dir


def build(source: str = "mttkrp.cu", defines: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` (with ``-D`` each of ``defines``) into
    :func:`build_dir` unless a library of the same source hash is there
    already. Returns the library's path and the compiler's report
    (``-Xptxas -v``: registers, shared memory, spills), kept beside the
    library."""
    out_dir = _build_dir  # one directory for the whole build
    src = CSRC / source
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS[:-2]).encode())  # the flags, the include path apart
    flags = tuple(f"-D{d}" for d in defines)
    if flags:  # (the production build's hash is the flags' alone)
        h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:12]
    lib = out_dir / f"lib{src.stem}_{digest}.so"
    report = lib.with_suffix(".log")
    if lib.exists():
        return lib, report.read_text() if report.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) on {src.name}:\n{proc.stdout}\n{proc.stderr}"
        )
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, proc.stdout + proc.stderr


def build_all(probe: bool = False) -> dict[str, tuple[Path, str]]:
    """Build every source at once, one ``nvcc`` process each (``probe``:
    and each one's write-probe build beside it, in the same pool); returns
    ``{source: (library path, compiler report)}`` of the production
    builds."""
    jobs = [(s, ()) for s in SOURCES] + ([(s, PROBE_DEFINES) for s in SOURCES] if probe else [])
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(lambda job: build(*job), jobs))
    return dict(zip(SOURCES, done))


_LOADED: dict[str, tuple[ctypes.CDLL, Path]] = {}


def _load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def library(source: str = "mttkrp.cu") -> ctypes.CDLL:
    """The kernel library of ``csrc/<source>``, built on first use and
    loaded once a process (never the write-probe build)."""
    if source not in _LOADED:
        path, _ = build(source)
        _LOADED[source] = (_load(path, SIGNATURES[source]), path)
    return _LOADED[source][0]


def loaded() -> dict[str, Path]:
    """``{source: path}`` of every library this process has loaded."""
    return {source: path for source, (_, path) in _LOADED.items()}


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# The write probe
# ---------------------------------------------------------------------------

_PROBE_LOADED: dict[str, ctypes.CDLL] = {}


def probe_library(source: str) -> ctypes.CDLL:
    """The write-probe build of ``csrc/<source>`` (``PROBE_DEFINES``), built
    on first use and loaded once a process, apart from :func:`library`'s."""
    if source not in _PROBE_LOADED:
        path, _ = build(source, PROBE_DEFINES)
        _PROBE_LOADED[source] = _load(path, {**SIGNATURES[source], **PROBE_SIGNATURES})
    return _PROBE_LOADED[source]


class WriteProbe:
    """The launches made inside :func:`write_probe`: one record a launch,
    ``{"source": ..., "buffers": [(buffer, counts), ...]}``, ``counts`` an
    int32 CUDA tensor of the buffer's elements and one overflow slot (see
    ``csrc/common.cuh``), filled once the launch has run."""

    def __init__(self) -> None:
        self.launches: list[dict] = []

    def arm(self, source: str, written) -> ctypes.CDLL:
        """The probe build of ``source`` with the buffers ``written``
        registered (fresh counts each), recorded as the next launch."""
        import torch

        lib = probe_library(source)
        check(lib.repro_write_probe_set(None, 0, 0, None), "write probe")
        buffers = []
        for t in written:
            counts = torch.zeros(t.numel() + 1, dtype=torch.int32, device=t.device)
            check(lib.repro_write_probe_set(t.data_ptr(), t.numel(), t.element_size(),
                                            counts.data_ptr()), "write probe")
            buffers.append((t, counts))
        self.launches.append({"source": source, "buffers": buffers})
        return lib


_probe: WriteProbe | None = None


@contextmanager
def write_probe():
    """Launch every Hopper kernel inside the block from the write-probe build
    of its source, each written buffer counted; yields the
    :class:`WriteProbe` that records them. The wrappers' ``launches`` do not
    move inside it."""
    global _probe
    if _probe is not None:
        raise RuntimeError("write_probe: a probe is active already")
    _probe = WriteProbe()
    try:
        yield _probe
    finally:
        _probe = None


def launch_library(source: str, *written) -> ctypes.CDLL:
    """The library a wrapper launches ``source``'s kernel from, writing the
    tensors ``written``: :func:`library`, or inside :func:`write_probe` the
    probe build with those buffers registered."""
    if _probe is None:
        return library(source)
    return _probe.arm(source, written)


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches += 1``, except
    for a launch of the probe build (inside :func:`write_probe`)."""
    if _probe is None:
        wrapper.launches += 1
