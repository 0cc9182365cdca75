"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into
`_build/<name>-<hash>.so` (plain C interface, loaded with ctypes); the hash
covers the source and the flags, so an edited source is rebuilt and a built
one is reused. Nothing here runs at import: the toolchain is looked up and
invoked only when a kernel is first launched, or when `build_all` is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) per source built here.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _target(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def _start(name: str, target: str) -> subprocess.Popen:
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build_all(names: Optional[list[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: seconds} for the sources compiled here."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names or sources():
        target = _target(name)
        if not os.path.exists(target):
            procs[name] = (target, _start(name, target))
    took = {}
    errors = []
    for name, (target, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        took[name] = time.perf_counter() - t0
        tmp = f"{target}.{os.getpid()}.tmp"
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        target = _target(name)
        if not os.path.exists(target):
            build_all([name])
        lib = ctypes.CDLL(target)
        _libraries[name] = lib
    return lib
