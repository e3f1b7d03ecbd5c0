"""Build and load the port's CUDA kernels.

Every ``detr_tpu_torch/csrc/*.cu`` compiles with nvcc into its own shared
library with a plain C interface, which ``ctypes`` loads.  The libraries land
in ``build/kernels/`` at the repository root, named by a hash of their source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one loads at once.  On first use all sources build
together, one nvcc process each.  Nothing
here runs at import: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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
