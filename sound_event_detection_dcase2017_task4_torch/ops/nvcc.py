"""Build a CUDA source of ``ops/csrc/`` into a shared library and load it.

The hand-written kernels have a plain C interface and are bound with
``ctypes``: ``nvcc`` compiles a source at first use into ``ops/_build/``
(listed in ``.gitignore``), once per version of the source and flags, and
the library is loaded from there. Importing this module needs neither
``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "FLAGS", "build_library", "nvcc"]

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


def build_library(source: Path, stem: str, flags=FLAGS,
                  build_dir: Path = BUILD_DIR):
    """Compile ``source`` with ``flags`` into ``build_dir`` (unless this
    version was built there before) and load it: ``(ctypes.CDLL, nvcc's
    output)``. Raises on any compiler or loader failure. The caller
    serialises calls."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    so_path = build_dir / f"lib{stem}_{tag}.so"
    log = "(loaded a library built earlier)"
    if not so_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc(), *flags, "-o", tmp, str(source)],
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
