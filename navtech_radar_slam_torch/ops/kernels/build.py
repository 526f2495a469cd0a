"""Build of one native source of the port into a ctypes library.

``NativeLibrary`` compiles one source with a compiler and flags into
``navtech_radar_slam_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source is rebuilt; the library has a
plain C interface and is loaded with ctypes.  ``start()`` launches the
compiler without waiting, so several sources build at once; ``load()``
waits, loads and binds.  A failed build raises with the compiler's output:
a kernel never falls back, and the CLI's scan source then reads with the
Python decoder (``runtime.loader``).

``KernelLibrary`` is the CUDA case: ``csrc/<name>.cu`` with ``nvcc
-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler
-fPIC -Xptxas -v``; each kernel module owns one.  The native scan loader
(``runtime/``) builds its C++ source with the host compiler (``g++``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Sequence

_PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


class NativeLibrary:
    """``source`` built by ``compiler`` (a callable giving its path) with
    ``flags`` and linked with ``libs``, as a loaded ctypes library; ``bind``
    sets the argtypes and restype of its exported functions."""

    def __init__(self, name: str, source: Path, compiler: Callable[[], str],
                 flags: Sequence[str], libs: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._compiler = compiler
        self._flags = tuple(flags)
        self._libs = tuple(libs)
        self._bind = bind
        #: the compiler's command line and its output for the build in this
        #: process ("" when the library was already built)
        self.command = ""
        self.log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None

    def _paths(self):
        key = self.source.read_bytes() + " ".join(self._flags + self._libs).encode()
        digest = hashlib.sha256(key).hexdigest()[:16]
        so = BUILD_DIR / f"{self.name}_{digest}.so"
        return so, so.with_name(f"{so.name}.{os.getpid()}.tmp")

    def start(self) -> None:
        """Start the compiler in the background unless the library is built."""
        if self._lib is not None or self._proc is not None:
            return
        so, tmp = self._paths()
        if so.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [self._compiler(), *self._flags, "-o", str(tmp), str(self.source), *self._libs]
        self.command = " ".join(cmd)
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)

    def load(self) -> ctypes.CDLL:
        """Build (waiting for ``start``'s compiler, if any), load and bind."""
        if self._lib is not None:
            return self._lib
        self.start()
        so, tmp = self._paths()
        if self._proc is not None:
            proc, self._proc = self._proc, None
            self.log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{self.name}: {self.command}\nfailed "
                                   f"({proc.returncode}):\n{self.log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        self._bind(lib)
        self._lib = lib
        return lib


class KernelLibrary(NativeLibrary):
    """``csrc/<name>.cu`` built by nvcc for sm_90a."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        super().__init__(name, _PKG / "csrc" / f"{name}.cu", nvcc, NVCC_FLAGS, (), bind)
