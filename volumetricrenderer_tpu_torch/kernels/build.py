"""Build and load the port's hand-written CUDA kernels.

Each kernel is a `.cu` file under csrc/ with a plain C entry point. It is
compiled with nvcc for Hopper (sm_90a) into a shared library at first use
and loaded with ctypes. Libraries land in the package's `_build/` directory
(ignored by git), named by a hash of the source, of every header under
csrc/ that it includes, and of the flags, so an edited source or header
rebuilds and an unchanged one loads at once. Nothing here runs at
import time, and a machine without nvcc raises instead of falling back.
check_sweep_inputs is the sweep wrappers' check of their arguments before
the pointers are passed to a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

__all__ = ["NVCC_FLAGS", "build_library", "source_key",
           "check_sweep_inputs"]

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _source_files(src: str):
    """src and every file it includes with #include "...", recursively,
    resolved against the including file's directory (as nvcc resolves
    them). System headers (<...>) are not part of the key."""
    seen, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return sorted(seen)


def source_key(src: str) -> str:
    """Hex digest over the flags and the bytes of src and of every header
    it includes: the name of its cached library."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(src):
        with open(path, "rb") as f:
            key.update(os.path.basename(path).encode() + b"\0" + f.read())
    return key.hexdigest()


def build_library(name: str):
    """Compile csrc/<name>.cu if needed and load it.

    Returns (ctypes.CDLL, info) where info holds the library path, the
    build seconds (0.0 when a cached library was loaded) and nvcc's
    output (the ptxas register and spill report)."""
    src = os.path.join(CSRC, name + ".cu")
    lib_path = os.path.join(BUILD_DIR, f"{name}-{source_key(src)[:16]}.so")
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



def check_sweep_inputs(kernel: str, stack, slice_z, v_grid, u_grid, seglen,
                       params, maps=None):
    """Check the arguments both sweep kernels share, plus `maps` (name ->
    (Hb, Wb) tensor), before their pointers go to a kernel: CUDA, the
    shapes the kernel assumes, contiguous float32. Returns
    (S, A, B, Hb, Wb)."""
    dev = stack.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} kernel: needs CUDA tensors, got {dev}")
    if stack.dim() != 3:
        raise ValueError(f"{kernel} kernel: stack must be (S, A, B), got "
                         f"{tuple(stack.shape)}")
    S, A, B = stack.shape
    Hb, Wb = v_grid.numel(), u_grid.numel()
    if min(S, A, B, Hb, Wb) < 1:
        raise ValueError(f"{kernel} kernel: empty input")
    named = [("stack", stack, (S, A, B)), ("slice_z", slice_z, (S,)),
             ("v_grid", v_grid, (Hb,)), ("u_grid", u_grid, (Wb,)),
             ("seglen", seglen, (Hb, Wb)), ("params", params, (8,))]
    named += [(k, t, (Hb, Wb)) for k, t in (maps or {}).items()]
    for name, t, shape in named:
        if t is None:
            raise ValueError(f"{kernel} kernel: {name} is required")
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"{kernel} kernel: {name} must be a contiguous float32 "
                f"tensor on {dev}; got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel} kernel: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    return S, A, B, Hb, Wb
