"""Lazy build and load of the port's host C++ libraries (counterpart of
``detr_tpu/utils/native_build.py``).

``NativeLib`` compiles one source under ``detr_tpu_torch/native/`` with the
host's C++ compiler into a shared library that ``ctypes`` loads, on first
use, into ``build/native/`` at the repository root (git-ignored; never
beside the source):

  * the library's name is keyed on the host's ISA and the source's content,
    ``lib<stem>.<host tag>.<source hash>.so``: a ``-march=native`` build is
    never loaded on another CPU, and an edited source is never served a
    stale library, not even within one process (glibc's ``dlopen`` caches by
    path, so a rebuild into the same name would keep the old symbols);
  * concurrent builds (spawned loader workers, parallel test processes)
    compile into a per-process temporary file and ``os.replace`` it into
    place; the temporary file is removed on every failure;
  * the flags the build took are written beside it (``.flags``) and kept in
    ``built_flags``;
  * superseded builds of the same source are removed after a build.

Without a compiler, or when every flag set fails, ``load()`` returns None and
the callers take their numpy paths.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILERS = ("g++", "clang++", "c++")


def _host_tag() -> str:
    """Stable per-ISA tag: the machine's architecture and its CPU flags line."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    key += line
                    break
    except OSError:
        pass
    return hashlib.sha1(key.encode()).hexdigest()[:10]


class NativeLib:
    """Builds and loads one source file, lazily.  ``bind(lib)`` sets the
    argtypes and restypes; ``flag_sets`` are tried in order, each with each
    compiler of ``COMPILERS``, until one compiles."""

    def __init__(
        self,
        src: str,
        flag_sets: Sequence[Sequence[str]],
        bind: Callable[[ctypes.CDLL], None],
        build_dir: Optional[str] = None,
    ):
        self._src = str(src)
        self._stem = Path(self._src).stem
        self._flag_sets = [list(fs) for fs in flag_sets]
        self._bind = bind
        self._build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False
        self.built_flags: Optional[str] = None  # compiler and flags of the loaded library

    def _lib_path(self) -> Path:
        with open(self._src, "rb") as f:
            src_hash = hashlib.sha1(f.read()).hexdigest()[:10]
        return self._build_dir / f"lib{self._stem}.{_host_tag()}.{src_hash}.so"

    def _build(self) -> Optional[Path]:
        out = self._lib_path()
        flags_file = out.with_suffix(".flags")
        if out.exists():
            self.built_flags = flags_file.read_text() if flags_file.exists() else "(unrecorded)"
            return out
        self._build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            for cxx in COMPILERS:
                for extra in self._flag_sets:
                    cmd = [cxx, "-O3", "-shared", "-fPIC", *extra, "-o", str(tmp), self._src]
                    try:
                        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                    except (OSError, subprocess.SubprocessError):
                        continue
                    self.built_flags = " ".join([cxx, "-O3", "-shared", "-fPIC", *extra])
                    flags_file.write_text(self.built_flags)
                    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
                    self._cleanup_superseded(keep=out)
                    return out
            return None
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _cleanup_superseded(self, keep: Path) -> None:
        for path in glob.glob(str(self._build_dir / f"lib{self._stem}.*.so")):
            if Path(path) != keep:
                for stale in (path, str(Path(path).with_suffix(".flags"))):
                    try:
                        os.unlink(stale)
                    except OSError:
                        pass

    def load(self) -> Optional[ctypes.CDLL]:
        """The loaded library, built on the first call; None without one."""
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            if not os.path.exists(self._src):
                return None
            path = self._build()
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(str(path))
                self._bind(lib)
                self._lib = lib
            except (OSError, AttributeError):
                self._lib = None
            return self._lib
