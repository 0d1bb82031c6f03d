"""nvcc builds of the port's CUDA sources (`aigv_assessor_torch/csrc/`).

Each source has a plain C interface and becomes one shared library under
`build/kernels/` at the root of the checkout, loaded with ctypes. A library
is built at first use, or when its source or a header in `csrc/` is newer;
`build` compiles several at once, one nvcc process per source, all started
together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


class CudaLibrary:
    """One source file in `csrc/` and the shared library built from it.
    `declare` sets the argtypes and restypes of the library's functions."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.path = BUILD_DIR / f"lib{self.source.stem}.so"
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None

    def up_to_date(self) -> bool:
        if not self.path.exists():
            return False
        inputs = [self.source, *CSRC.glob("*.cuh")]  # any source may include any header
        return self.path.stat().st_mtime >= max(f.stat().st_mtime for f in inputs)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.path))
            self._declare(lib)
            lib.aigv_cuda_error_string.argtypes = [ctypes.c_int]
            lib.aigv_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launch function returned a CUDA error."""
        if rc != 0:
            raise RuntimeError(
                f"{what} launch failed: " + self.load().aigv_cuda_error_string(rc).decode()
            )


def build(libraries: Sequence[CudaLibrary], verbose: bool = False) -> float:
    """Compile every library that is missing or older than its source, one
    nvcc process per source, all started together. Returns the wall seconds
    (0.0 if all were up to date). Each library is written to a temporary
    name and renamed, so a process building it concurrently never loads a
    half-written file."""
    stale = [lib for lib in libraries if not lib.up_to_date()]
    if not stale:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    try:
        for lib in stale:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                   "-o", tmp, str(lib.source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            jobs.append((lib, tmp, cmd, proc))
        failures = []
        for lib, tmp, cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
                continue
            if verbose:
                print(err, end="")
            os.replace(tmp, lib.path)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return time.perf_counter() - t0
