"""Build and load the port's CUDA kernels (nvcc by hand, plain C ABI, ctypes).

The sources under ``csrc/`` are compiled at first use into
``build/repro_torch/`` under the repository root, one shared library per
source, named by a hash of the source, the headers it includes, the flags and
the compiler, so an edit rebuilds and an unchanged tree reuses the library.
:func:`load_all` starts one ``nvcc`` per source, all at once.  Nothing here
touches CUDA when the module is imported: the CPU tests import every module of
the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}  # source name -> its build/load lock
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # source name -> nvcc wall time (0.0 when reused)


class KernelBuildError(RuntimeError):
    """A kernel's library could not be built: nvcc is missing or failed."""


class KernelLaunchError(RuntimeError):
    """A kernel could not be launched: the launch (or its occupancy query)
    returned a launch-local CUDA error, or its workspace would be allocated
    during a capture.  The fault guard (``kernels/ops.py``) contains these."""


# CUDA runtime codes a launch returns for a fault of that launch alone, which
# leave the context usable: another config (or a rebuilt capture) may succeed.
LAUNCH_LOCAL_ERRORS = {
    1: "cudaErrorInvalidValue",
    2: "cudaErrorMemoryAllocation",
    9: "cudaErrorInvalidConfiguration",
    98: "cudaErrorInvalidDeviceFunction",
    200: "cudaErrorInvalidKernelImage",
    209: "cudaErrorNoKernelImageForDevice",
    400: "cudaErrorInvalidResourceHandle",
    701: "cudaErrorLaunchOutOfResources",
    720: "cudaErrorCooperativeLaunchTooLarge",
    801: "cudaErrorNotSupported",
    900: "cudaErrorStreamCaptureUnsupported",
    901: "cudaErrorStreamCaptureInvalidated",
}


def launch_error(err: int, text: str) -> RuntimeError:
    """The error to raise for a launch that returned CUDA code ``err``.

    A launch returns ``cudaGetLastError()``, which also reports a sticky
    error an earlier asynchronous kernel left (an illegal address, 700; a
    launch failure, 719; 999, ...).  Such an error poisons the context, so
    the config that happened to launch next is not at fault and nothing in
    this process can retry: it is raised as ``torch.AcceleratorError``,
    which the fault guard does not contain.  Only the codes of
    :data:`LAUNCH_LOCAL_ERRORS` raise :class:`KernelLaunchError`."""
    import torch

    if err in LAUNCH_LOCAL_ERRORS:
        return KernelLaunchError(text)
    return getattr(torch, "AcceleratorError", RuntimeError)(f"{text}; the CUDA context is unusable (sticky error)")


def refuse_under_capture(what: str) -> None:
    """Raise :class:`KernelLaunchError` if the current stream is capturing a
    CUDA graph: a kernel's workspace allocated (or grown) there would be
    captured, not made, and a graph keeps the address it captured."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        raise KernelLaunchError(f"{what} would be allocated during a CUDA graph capture; run the captured body once "
                                f"on the capture stream first (or reserve the workspace)")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the port's CUDA "
            "kernels are built from source at first use and need the CUDA toolkit"
        )
    return found


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the headers under ``csrc/`` it includes (``#include "..."``,
    followed through headers that include others)."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)]
    return seen


def library_path(name: str, nvcc: str) -> Path:
    """The library's path, named by a hash of the source, the headers it includes, the
    flags and the compiler: an edit to any of them builds a new library."""
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, nvcc: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(f"$ {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}); see {log}\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees the whole file or none


def _lock_for(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    with _lock_for(name):
        lib = _libs.get(name)
        if lib is not None:
            return lib
        nvcc = nvcc_path()
        out = library_path(name, nvcc)
        t0 = time.perf_counter()
        if not out.is_file():
            _compile(name, nvcc, out)
            build_seconds[name] = time.perf_counter() - t0
        else:
            build_seconds[name] = 0.0
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Build and load every named source, one ``nvcc`` per source, in parallel."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(load, name) for name in names}
    return {name: fut.result() for name, fut in futures.items()}


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory report) for ``name``."""
    log = library_path(name, nvcc_path()).with_suffix(".log")
    return log.read_text() if log.is_file() else ""
