"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (sm_90a)
into a shared library with a plain ``extern "C"`` interface, under
``build/repro_torch_kernels/`` at the root of the checkout (``.gitignore``
lists ``build/``); ``$REPRO_TORCH_BUILD_DIR`` names another directory,
and a package installed outside a checkout builds under the working
directory's ``build/``. The file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one loads the library already built. A
missing or failing ``nvcc`` raises with its output: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    named = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if named:
        return Path(named)
    src = Path(__file__).resolve().parents[2]       # src/ in a checkout
    root = src.parent if src.name == "src" and \
        (src.parent / "pyproject.toml").is_file() else Path.cwd()
    return root / "build" / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()                       # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}     # one per source
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, every header beside it (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{key[:16]}.so"


def _compile(name: str, out: Path) -> None:
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders in
    # other processes never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd: List[str] = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{proc.stderr}{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The compiled library for ``csrc/<name>.cu``, building it first if
    this source has not been built yet. Builds of different sources may
    run at once (see :func:`build_all`)."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _compile(name, path)
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Build (or load) several libraries at once, one ``nvcc`` for each
    source, all started together. Returns each one's seconds; raises the
    first build error."""
    def timed(name: str) -> float:
        t0 = time.perf_counter()
        load(name)
        return time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        secs = list(pool.map(timed, names))
    return dict(zip(names, secs))


def error_string(name: str, code: int) -> str:
    """The CUDA error message for ``code``, as ``csrc/<name>.cu``'s
    ``<name>_error_string`` (cudaGetErrorString) gives it."""
    fn = getattr(load(name), f"{name}_error_string")
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return fn(code).decode()


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory use) from the
    build of ``name``, or "" when the library was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
