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
    },
    "sweep.cu": {
        "repro_fused_pair": (_I, [_I, _I, _PLL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _PLL, _P,
                                  _P, _P]),
        "repro_partial": (_I, [_I, _I, _I, _I, _I, _I, _I, _PLL, _PLL, _I, _PLL, _PLL, _I, _I,
                               _LL, _PLL, _P, _PLL, _P, _P]),
        "repro_fused_pair_smem_bytes": (_LL, [_I, _I, _I, _I, _I, _I]),
        "repro_partial_smem_bytes": (_LL, [_I, _I, _I, _I, _I, _I]),
    },
    "multi_ttm.cu": {
        "repro_multi_ttm": (_I, [_I, _I, _PLL, _PI, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _PLL,
                                 _P, _PLL, _P, _P]),
        "repro_multi_ttm_smem_bytes": (_LL, [_I, _I, _PI, _I, _I, _I, _I]),
    },
    "ssd_intra.cu": {
        "repro_ssd_intra": (_I, [_I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P]),
        "repro_ssd_intra_smem_bytes": (_LL, [_I, _I, _I, _I]),
    },
}


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


def build(source: str = "mttkrp.cu") -> tuple[Path, str]:
    """Compile ``csrc/<source>`` into :func:`build_dir` unless a library of
    the same source hash is there already. Returns the library's path and
    the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills), kept beside the library."""
    out_dir = _build_dir  # one directory for the whole build
    src = CSRC / source
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS[:-2]).encode())  # the flags, the include path apart
    digest = h.hexdigest()[:12]
    lib = out_dir / f"lib{src.stem}_{digest}.so"
    report = lib.with_suffix(".log")
    if lib.exists():
        return lib, report.read_text() if report.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) on {src.name}:\n{proc.stdout}\n{proc.stderr}"
        )
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib, proc.stdout + proc.stderr


def build_all() -> dict[str, tuple[Path, str]]:
    """Build every source at once, one ``nvcc`` process each; returns
    ``{source: (library path, compiler report)}``."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


_LOADED: dict[str, tuple[ctypes.CDLL, Path]] = {}


def library(source: str = "mttkrp.cu") -> ctypes.CDLL:
    """The kernel library of ``csrc/<source>``, built on first use and
    loaded once a process."""
    if source not in _LOADED:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LOADED[source] = (lib, path)
    return _LOADED[source][0]


def loaded() -> dict[str, Path]:
    """``{source: path}`` of every library this process has loaded."""
    return {source: path for source, (_, path) in _LOADED.items()}


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
