"""nvcc build of one ``csrc/*.cu`` source into a ctypes library.

Each kernel module owns one ``KernelLibrary``.  The library is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC -Xptxas -v`` into ``navtech_radar_slam_torch/_build/``
(git-ignored), named by the source's hash, so an edited source is rebuilt;
it has a plain C interface and is loaded with ctypes.  ``start()`` launches
nvcc without waiting, so several sources build at once; ``load()`` waits,
loads and binds.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional

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


class KernelLibrary:
    """``csrc/<name>.cu`` as a loaded ctypes library; ``bind`` sets the
    argtypes and restype of its exported functions."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = _PKG / "csrc" / f"{name}.cu"
        self._bind = bind
        #: what nvcc / ptxas printed for the build in this process ("" when
        #: the library was already built)
        self.log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None

    def _paths(self):
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"{self.name}_{digest}.so"
        return so, so.with_name(f"{so.name}.{os.getpid()}.tmp")

    def start(self) -> None:
        """Start nvcc in the background unless the library is built."""
        if self._lib is not None or self._proc is not None:
            return
        so, tmp = self._paths()
        if so.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def load(self) -> ctypes.CDLL:
        """Build (waiting for ``start``'s nvcc, if any), load and bind."""
        if self._lib is not None:
            return self._lib
        self.start()
        so, tmp = self._paths()
        if self._proc is not None:
            proc, self._proc = self._proc, None
            self.log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{self.name}: nvcc failed ({proc.returncode}):\n{self.log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        self._bind(lib)
        self._lib = lib
        return lib
