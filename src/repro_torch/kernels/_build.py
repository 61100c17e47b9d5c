"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded through ``ctypes``: no
PyTorch headers, so a build takes seconds, not minutes.  Libraries land
in ``build/repro_torch/<hash>/`` at the repository root, keyed by a hash
of every source and the compiler flags, so an edited kernel rebuilds
and an unchanged one loads from disk.  Nothing here runs at import
time: the package imports on a machine with no ``nvcc`` and no card.

Builds are serialized by a thread lock (ingest workers are threads)
and a file lock (several processes may share one checkout); each
library is written to a temporary name and renamed into place.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent.parent / "build" / "repro_torch"
SOURCES = ("delta_codec", "transcode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # every float op is the IEEE one the plain versions perform: no fast
    # math, no flush-to-zero, no contraction of a*b+c into one rounding
    "--fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the port's"
        " CUDA kernels are built at first use on the machine with the card"
    )


@functools.lru_cache(maxsize=None)
def build_dir() -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _compile(names: Iterable[str]) -> None:
    """Run one ``nvcc`` per missing library, all started together."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        todo = [n for n in names if not _lib_path(n).exists()]
        if not todo:
            return
        nvcc = _nvcc()
        procs: List = []
        for name in todo:
            tmp = out_dir / f"lib{name}.so.tmp-{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs.append((name, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            (out_dir / f"{name}.log").write_bytes(log)
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
                continue
            os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_all() -> Dict[str, float]:
    """Build every kernel library (in parallel) and load it; returns the
    seconds each ``nvcc`` took in this call (empty when all were built)."""
    build_seconds.clear()
    with _lock:
        _compile(SOURCES)
        for name in SOURCES:
            _load_locked(name)
    return dict(build_seconds)


def _load_locked(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            _compile([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.vss_error_string.argtypes = [ctypes.c_int]
        lib.vss_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        return _load_locked(name)


def ptxas_log(name: str) -> str:
    """The compiler's register/spill report for ``name``, written next
    to the library when it was built (empty if there is none)."""
    path = build_dir() / f"{name}.log"
    return path.read_text(errors="replace") if path.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.vss_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


# -- launch counters --------------------------------------------------------

_count_lock = threading.Lock()
launches: Dict[str, int] = {}


def count_launch(name: str) -> None:
    """One more launch of kernel ``name`` (called by its wrapper, right
    where it launches, and nowhere else)."""
    with _count_lock:
        launches[name] = launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(launches)


def reset_launch_counts() -> None:
    with _count_lock:
        launches.clear()
