"""The port's native (C++) code: the triangle-hash inside-mesh test of the
SIV metric (triangle_hash.cpp, a copy of the JAX package's), bound over
ctypes.

The library is built with g++ at first use into native/_build/ (listed in
.gitignore), named by a hash of the source and the flags, so an edited
source rebuilds. A failed build or load raises: there is no silent fallback
(eval/inside_mesh.py has the numpy version, which a caller asks for by
name). Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "triangle_hash.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libtamf_native-{h}.so")


def build() -> str:
    """Compile the library unless it is there; returns its path. Raises
    RuntimeError when no C++ compiler is found or the compile fails."""
    so = library_path()
    if os.path.isfile(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found to build the inside-mesh library")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (rc {r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builds leave one complete file
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.inside_mesh_query.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.inside_mesh_query.restype = None
            _lib = lib
        return _lib


def inside_mesh_native(verts: np.ndarray, faces: np.ndarray, points: np.ndarray,
                       resolution: int = 512) -> np.ndarray:
    """C++ spatial-hash ray-parity inside test: bool [n_points]."""
    v = np.ascontiguousarray(verts, dtype=np.float64).reshape(-1, 3)
    f = np.ascontiguousarray(faces, dtype=np.int32).reshape(-1, 3)
    p = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= v.shape[0]):
        raise ValueError(f"face index out of range for {v.shape[0]} vertices")
    out = np.zeros(p.shape[0], dtype=np.uint8)
    get_lib().inside_mesh_query(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), p.shape[0],
        int(resolution), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)
