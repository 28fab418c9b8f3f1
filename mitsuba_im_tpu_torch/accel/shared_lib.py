"""Sources of ``csrc/`` built at first use into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each library is built into ``build/mitsuba_im_tpu_torch/`` at the
repository root, under a name keyed by a hash of its source and flags, so
a changed source or flag builds anew and an unchanged one loads at once.
A failed build raises with the compiler's output: nothing falls back.
Builds of different libraries may run in parallel threads (the compiler
runs in a subprocess).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "mitsuba_im_tpu_torch"


def nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    path = str(cand) if cand.exists() else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (/usr/local/cuda/bin/nvcc)")
    return path


def cxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("no host C++ compiler (g++) found: the BVH "
                           "builder is C++")
    return path


class SharedLibrary:
    """One source file, its compiler and flags, and the ``ctypes`` binding
    that ``bind`` sets up (argument and result types) after loading."""

    def __init__(self, source: str, compiler: Callable[[], str],
                 flags: tuple, bind: Callable[[ctypes.CDLL], None],
                 ldflags: tuple = ()):
        self.source = CSRC / source
        self.compiler = compiler
        self.flags = tuple(flags)
        self.ldflags = tuple(ldflags)
        self.bind = bind
        self.log = ""  # the compiler's output (ptxas register report)
        self.seconds = 0.0  # build time, 0 when the library was cached
        self._lib = None

    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(self.flags + self.ldflags).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """Build (if the source hash is new) and load the library."""
        if self._lib is not None:
            return self._lib
        so = self.path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [self.compiler(), *self.flags, str(self.source), "-o",
                 str(tmp), *self.ldflags], capture_output=True, text=True)
            self.seconds = time.perf_counter() - t0
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"building {self.source.name} failed "
                                   f"({proc.returncode}):\n{self.log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        self.bind(lib)
        self._lib = lib
        return lib
