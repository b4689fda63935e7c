"""Build a CUDA source of ``ops/csrc/`` into a shared library and load it.

The hand-written kernels have a plain C interface and are bound with
``ctypes``. Each library module declares one :class:`Library`: its source,
the argtypes and restypes of its entries, and the entry that names an
error code. ``nvcc`` compiles the source at its first use into
:data:`BUILD_DIR` (``ops/_build/``, listed in ``.gitignore``) with
:data:`FLAGS`, once per version of the source and flags, both read when the
library is built; the library is loaded from there. Importing this module
needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

import torch

__all__ = ["BUILD_DIR", "FLAGS", "Library", "build_library", "nvcc", "stream"]

BUILD_DIR = Path(__file__).parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build "
                       "the port's CUDA kernels")


def build_library(source: Path, stem: str):
    """Compile ``source`` with :data:`FLAGS` into :data:`BUILD_DIR` (unless
    this version was built there before) and load it: ``(ctypes.CDLL,
    nvcc's output)``. Raises on any compiler or loader failure. The caller
    serialises calls."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    build_dir = Path(BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    so_path = build_dir / f"lib{stem}_{tag}.so"
    log = "(loaded a library built earlier)"
    if not so_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc(), *FLAGS, "-o", tmp, str(source)],
                                  capture_output=True, text=True, timeout=600)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {source}:\n{log}")
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(so_path)), log


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


class Library:
    """One ``.cu`` source, built and loaded once a process at the first
    :meth:`load`. ``entries`` maps each entry to ``(restype, argtypes)``;
    ``errors`` names the entry that gives a code's message; ``on_load(lib)``
    checks the loaded library. ``log`` is nvcc's output (``-Xptxas -v``)
    of the build loaded, ``None`` before it."""

    def __init__(self, source: Path, stem: str, entries: dict, errors: str,
                 on_load: Callable | None = None):
        self.source, self.stem, self.errors, self.on_load = source, stem, errors, on_load
        self.entries = {**entries, errors: (ctypes.c_char_p, [ctypes.c_int])}
        self.log: str | None = None
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """The loaded library, its entries declared. Raises on any compiler
        or loader failure and on a failed ``on_load`` (again at the next
        call)."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                lib, log = build_library(self.source, self.stem)
                for name, (restype, argtypes) in self.entries.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                if self.on_load is not None:
                    self.on_load(lib)
                self._lib, self.log = lib, log
            return self._lib

    def error(self, rc: int, what: str) -> RuntimeError:
        """``RuntimeError("<what> failed: <the library's message> (<rc>)")``
        for an entry's non-zero code ``rc``."""
        msg = getattr(self._lib, self.errors)(rc).decode()
        return RuntimeError(f"{what} failed: {msg} ({rc})")
