"""Build the port's native sources into shared libraries at first use.

Libraries go to ``build/torch_kernels/`` at the root of the checkout (a
directory ``.gitignore`` lists), named by a hash of their sources and
command, so an edited source builds anew and an unchanged one is loaded as
it is.  A failed build raises: no caller falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

__all__ = ["BUILD_DIR", "load_library", "build_log", "nvcc_command",
           "gxx_command"]

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_command(*extra: str) -> list:
    """nvcc for Hopper (``sm_90a``) into a plain-C shared library."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", *extra]


def gxx_command(*extra: str) -> list:
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *extra]


def load_library(name: str, sources: Sequence[str],
                 command: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` (paths inside the package) with ``command``
    into ``BUILD_DIR`` unless already built, and load the result."""
    paths = [os.path.join(_PKG, s) for s in sources]
    digest = hashlib.sha256(" ".join(command[1:]).encode())
    for p in paths:
        with open(p, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    with _lock:
        if out in _loaded:
            return _loaded[out]
    # compile outside the lock, so that libraries build in parallel threads
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [*command, "-o", tmp, *paths]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building {name} failed: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(cmd)}):\n"
                f"{res.stdout}{res.stderr}")
        with open(f"{tmp}.log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(f"{tmp}.log", f"{out}.log")
        os.replace(tmp, out)  # atomic: concurrent builds agree
    with _lock:
        if out not in _loaded:
            _loaded[out] = ctypes.CDLL(out)
        return _loaded[out]


def build_log(lib: ctypes.CDLL) -> str:
    """What the compiler printed while building ``lib`` ("" if unknown)."""
    try:
        with open(f"{lib._name}.log") as f:
            return f.read()
    except OSError:
        return ""
