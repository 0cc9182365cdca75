"""ctypes bridge to the native C++ HEM (`native/hem.cpp`), built on demand.

Torch counterpart of `gaussiansplattingregistration_tpu/utils/native.py`.
The library exposes a flat-array C ABI; numpy buffers pass through ctypes
without copies. It is compiled with g++ (-O3 -fopenmp) on first use into
the port's `_build/` directory (gitignored), under a name that hashes the
source and the flags. It never writes next to the source: the file
`native/libgsrhem.so` belongs to the JAX package. Without g++, or when the
build fails, the bridge raises; callers do not fall back to torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(os.path.dirname(_PKG_DIR), "native", "hem.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(SRC_PATH, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libgsrhem-{digest.hexdigest()[:16]}.so")


def _build(target: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the native HEM backend needs g++, which is not on PATH")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, SRC_PATH, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC_PATH}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, target)


def load_library() -> ctypes.CDLL:
    """The native library, built first into `BUILD_DIR` (the port's
    `_build/`) when missing. Raises RuntimeError when it cannot be built or
    loaded."""
    target = library_path()
    with _lock:
        lib = _libraries.get(target)
        if lib is not None:
            return lib
        if not os.path.exists(target):
            _build(target)
        lib = ctypes.CDLL(target)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.gsr_hem_cluster_level.restype = ctypes.c_int
        lib.gsr_hem_cluster_level.argtypes = [
            ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, f32p, f32p, f32p, f32p, u8p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            f32p, f32p, f32p, f32p, f32p, f32p, f32p,
        ]
        lib.gsr_hem_num_threads.restype = ctypes.c_int
        lib.gsr_hem_num_threads.argtypes = []
        _libraries[target] = lib
        return lib


def hem_cluster_level_native(
    mean: np.ndarray, color: np.ndarray, cov6: np.ndarray,
    opacity: np.ndarray, weight: np.ndarray, features: np.ndarray,
    nvar: np.ndarray, is_parent: np.ndarray,
    distance_delta: float, color_delta: float, decay_rate: float,
):
    """One HEM round on the host. Returns the compacted output arrays
    (mean, color, cov6, opacity, weight, features, nvar)."""
    lib = load_library()
    n = int(mean.shape[0])
    fdim = int(features.shape[1]) if features.ndim == 2 else 0
    c = lambda a, shape: np.ascontiguousarray(a, dtype=np.float32).reshape(shape)  # noqa: E731
    mean, color, cov6, nvar = c(mean, (n, 3)), c(color, (n, 3)), c(cov6, (n, 6)), c(nvar, (n, 3))
    opacity, weight = c(opacity, (n,)), c(weight, (n,))
    features = c(features, (n, fdim)) if fdim else np.zeros((n, 1), np.float32)
    is_parent = np.ascontiguousarray(is_parent, dtype=np.uint8).reshape(n)

    out = [np.empty(s, np.float32) for s in
           ((n, 3), (n, 3), (n, 6), (n,), (n,), (n, max(fdim, 1)), (n, 3))]
    count = lib.gsr_hem_cluster_level(
        n, max(fdim, 1), mean, color, cov6, opacity, weight, features, nvar,
        is_parent, float(distance_delta), float(color_delta), float(decay_rate), *out,
    )
    if count < 0:
        raise RuntimeError(f"gsr_hem_cluster_level failed (returned {count})")
    o_mean, o_color, o_cov6, o_opacity, o_weight, o_features, o_nvar = (a[:count] for a in out)
    return (o_mean, o_color, o_cov6, o_opacity, o_weight, o_features[:, :fdim], o_nvar)
