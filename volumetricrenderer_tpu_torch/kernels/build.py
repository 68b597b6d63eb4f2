"""Build and load the port's hand-written CUDA kernels.

Each kernel is a `.cu` file under csrc/ with a plain C entry point. It is
compiled with nvcc for Hopper (sm_90a) into a shared library at first use
and loaded with ctypes. Libraries land in the package's `_build/` directory
(ignored by git), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once. Nothing here runs at
import time, and a machine without nvcc raises instead of falling back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["NVCC_FLAGS", "build_library"]

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")

# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions compute them: the tap coordinates, and so the
# in-box tests and texel indices, then agree bit for bit. No fast-math:
# parity with the plain versions is the contract.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use")


def build_library(name: str):
    """Compile csrc/<name>.cu if needed and load it.

    Returns (ctypes.CDLL, info) where info holds the library path, the
    build seconds (0.0 when a cached library was loaded) and nvcc's
    output (the ptxas register and spill report)."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")
    info = {"path": lib_path, "seconds": 0.0, "log": ""}
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                + info["log"])
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path), info
