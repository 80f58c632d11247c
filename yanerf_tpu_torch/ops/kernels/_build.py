"""Build a CUDA source of ``csrc/`` with nvcc (or a C++ source with the host's g++) into a shared library and load
it with ctypes.

One compiler run per source, cached by content under ``yanerf_tpu_torch/_build/``
(listed in ``.gitignore``), with the compiler's report kept beside the
library. The content is that of the source and of every header it
includes from its directory (``#include "..."``, followed recursively), so
an edit of a shared header rebuilds every library that includes it.
Nothing here runs at import: a library is built at its first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, List

PACKAGE_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = PACKAGE_DIR / "_build"
CSRC_DIR = PACKAGE_DIR / "csrc"
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)
# no --use_fast_math: the embedding's phases reach |x| * 2^9 rad, where the
# fast sine is wrong. -Xptxas -v reports registers, shared memory, spills.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# host code: no -march=native, the cache key does not name the machine
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc was not found: the CUDA kernels cannot be built")
    return nvcc


def _gxx() -> str:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ was not found: the native host code cannot be built")
    return gxx


class CudaLibrary:
    """A ``csrc/*.cu`` source, its cached build and its ctypes handle.

    ``bind`` sets the ``argtypes``/``restype`` of the library's entry points
    once it is loaded. A relative ``source`` is taken from ``csrc/``.
    """

    flags = NVCC_FLAGS
    compiler_name = "nvcc"

    def _compiler(self) -> List[str]:
        return [_nvcc(), *self.flags]

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]) -> None:
        self.source = CSRC_DIR / source
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def sources(self) -> List[Path]:
        """The source, then every file it includes from its directory, directly or not, each once."""
        order: List[Path] = []
        todo = [self.source]
        while todo:
            path = todo.pop(0)
            if path in order:
                continue
            order.append(path)
            for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
                header = path.parent / name.decode()
                if header.is_file():
                    todo.append(header)
        return order

    def path(self) -> Path:
        digest = hashlib.sha256(" ".join(self.flags).encode())
        for path in self.sources():
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source, cached by content; the compiler's report goes to a ``.log`` beside it."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([*self._compiler(), "-o", tmp, str(self.source)], capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{self.compiler_name} failed on {self.source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        return out

    def build_report(self) -> str:
        """The ptxas lines of the last build: registers, spills, shared memory."""
        log = self.path().with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        return "; ".join(line.split(":", 1)[-1].strip() for line in lines if "registers" in line or "spill" in line)

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib

    def load(self) -> float:
        """Build (if needed) and load the library; returns the seconds it took."""
        t0 = time.perf_counter()
        self.library()
        return time.perf_counter() - t0


class HostLibrary(CudaLibrary):
    """A C++ source for the host, built with ``g++`` (no CUDA) and cached the same way."""

    flags = GXX_FLAGS
    compiler_name = "g++"

    def _compiler(self) -> List[str]:
        return [_gxx(), *self.flags]
