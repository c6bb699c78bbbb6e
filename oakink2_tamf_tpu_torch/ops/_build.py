"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface and loaded with ctypes. The build runs at
first use into `ops/_build/` (listed in .gitignore), keyed by a hash of the
sources, so a changed source rebuilds; ptxas' report (`Kernel.ptxas_log`)
is kept beside each library. `build_all()` starts one `nvcc` per source at
once.

Nothing here runs at import: the CPU tests import every module of the port,
and a machine without a GPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


class Kernel:
    """One CUDA source, its library and its launch count.

    `launches` is the number of times a wrapper launched this kernel; the
    wrapper adds one per launch and nothing else touches it except callers
    that reset it to 0 before a measured run."""

    def __init__(self, name: str, source: str, replaces: str, symbol: str, argtypes):
        self.name = name
        self.source = source  # file name under csrc/
        self.replaces = replaces  # the TPU kernel it ports, file:line
        self.symbol = symbol  # the C launch function, returns cudaGetLastError()
        self.argtypes = argtypes
        self.launches = 0
        self.ptxas_log = ""
        self._lib: ctypes.CDLL | None = None

    def _paths(self) -> tuple[str, str]:
        h = hashlib.sha256()
        for fn in sorted(os.listdir(CSRC)):  # the .cu and the shared headers
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        so = os.path.join(BUILD_DIR, f"{self.name}-{h.hexdigest()[:12]}.so")
        return os.path.join(CSRC, self.source), so

    def start_build(self):
        """Start nvcc for this kernel unless its library is already built.
        Returns (process, temporary output, final path) or None."""
        src, so = self._paths()
        if os.path.isfile(so):
            if not self.ptxas_log and os.path.isfile(f"{so}.ptxas"):  # built by an earlier process
                with open(f"{so}.ptxas") as f:
                    self.ptxas_log = f.read()
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp, so

    def finish_build(self, started) -> None:
        """Wait for a build from start_build and move the library in place."""
        if started is None:
            return
        proc, tmp, so = started
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} (rc {proc.returncode}):\n{out}")
        self.ptxas_log = out
        with open(f"{tmp}.ptxas", "w") as f:  # beside the library, for a later process
            f.write(out)
        os.replace(f"{tmp}.ptxas", f"{so}.ptxas")
        os.replace(tmp, so)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with _lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(self._paths()[1])
                self._bind(self._lib)
            return self._lib

    def _bind(self, lib: ctypes.CDLL) -> None:
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p

    def launch(self, *args) -> None:
        """Call the C launch function, count the launch, raise on a CUDA error."""
        lib = self.lib()
        rc = getattr(lib, self.symbol)(*args)
        with _count_lock:  # wrappers also launch from the loader's threads (cache misses)
            self.launches += 1
        if rc != 0:
            msg = lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: cuda error {rc} ({msg})")


def build_all(kernels) -> None:
    """Build every kernel's library, one nvcc per source, all started together."""
    with _lock:
        procs = [(k, k.start_build()) for k in kernels]
        for k, p in procs:
            k.finish_build(p)
    for k in kernels:
        k.lib()
