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

Every wrapper binds (:func:`bind`), launches and counts (:func:`launch`)
an entry through this module. Every entry returns 0, a positive
``cudaError_t`` or a negative code of its library's own (:func:`check`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# a library's own return codes: each one's exception type and message
Errors = Mapping[int, Tuple[type, str]]


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
_count_lock = threading.Lock()                  # guards every .launches
# names this process ran nvcc for, in order: a replica tier's children
# report it, so a child that built instead of loading shows
compiled: List[str] = []


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


def _compile(src: Path, out: Path) -> None:
    """Build ``src`` into the library ``out``."""
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders in
    # other processes never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd: List[str] = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{proc.stderr}{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)
    compiled.append(src.stem)


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
                _compile(CSRC / f"{name}.cu", path)
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


@functools.lru_cache(maxsize=None)
def bind(lib: ctypes.CDLL, name: str, argtypes: tuple):
    """``lib``'s entry ``name`` with ``argtypes`` and an int return code,
    bound once for each library and entry."""
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def check(lib: str, rc: int, errors: Errors, detail: tuple = ()) -> None:
    """Raise for an entry of ``csrc/<lib>.cu`` that returned ``rc`` != 0:
    a code in ``errors`` (the library's own, negative) as its exception
    with its message formatted with ``detail``, any other as RuntimeError
    with the CUDA error message."""
    if rc in errors:
        exc, message = errors[rc]
        raise exc(message.format(*detail))
    if rc:
        raise RuntimeError(f"{lib} kernel launch failed ({rc}): "
                           f"{error_string(lib, rc)}")


def launch(counted, lib: str, entry, device: torch.device, args: tuple,
           errors: Errors, detail: tuple = ()) -> None:
    """``entry(*args, stream)`` with the raw handle of ``device``'s
    current stream, ``device`` being the current device for the call;
    raises for its return code (:func:`check`), else adds one to
    ``counted.launches`` (``counted`` None counts nothing). The raw
    handle and the guard only where it is needed: a Stream object and a
    device guard on every launch cost ~10 us of host time on the H100's
    host (``python -m repro_torch.kernels.conv_tile_probe``), where a
    served batch's kernel takes ~40 us."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = entry(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = entry(*args, stream)
    check(lib, rc, errors, detail)
    if counted is not None:
        with _count_lock:
            counted.launches += 1


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory use) from the
    build of ``name``, or "" when the library was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
