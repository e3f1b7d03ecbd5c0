"""Build and load the port's CUDA kernels.

Every ``detr_tpu_torch/csrc/*.cu`` compiles with nvcc into its own shared
library with a plain C interface, which ``ctypes`` loads.  The libraries land
in ``build/kernels/`` at the repository root, named by a hash of their source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one loads at once.  On first use all sources build
together, one nvcc process each.  Nothing
here runs at import: the CPU tests import every module of the package.

The C interface: every entry point returns an int, and a launch takes the
CUDA stream as its last argument and returns its ``cudaError_t`` (0 is
success); ``kernel`` binds an entry point and ``launch`` makes the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source stem -> nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source under csrc/ whose library is missing, all nvcc
    processes started together; return {source stem: library path}.
    Raises RuntimeError with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for stem, (src, so) in targets.items():
        if so.exists():
            log = so.with_suffix(".log")
            build_logs[stem] = log.read_text() if log.exists() else ""
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so)
    failed = []
    for stem, (proc, tmp, so) in procs.items():
        output, _ = proc.communicate()
        build_logs[stem] = output
        if proc.returncode != 0:
            failed.append(f"--- nvcc {stem}.cu (exit {proc.returncode}) ---\n{output}")
            continue
        so.with_suffix(".log").write_text(output)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        message = "\n".join(failed)
        print(message, flush=True)
        raise RuntimeError(f"kernel build failed:\n{message}")
    return {stem: so for stem, (_, so) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no kernel source csrc/{stem}.cu")
            _libs[stem] = ctypes.CDLL(str(paths[stem]))
        return _libs[stem]


def kernel(stem: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """``symbol`` of the library built from ``csrc/<stem>.cu``, its
    ``argtypes`` and its ``c_int`` return type set on first use (the
    library hands out the same function object on every lookup)."""
    fn = getattr(load(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch(fn: ctypes._CFuncPtr, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` with ``device`` current, on its current stream;
    raises RuntimeError on a nonzero ``cudaError_t``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
