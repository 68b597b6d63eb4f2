"""A probe of the bfloat16 stream mode's weight rounding
(csrc/round_probe.cu): the device's round_weight<__nv_bfloat16>
(__float2bfloat16_rn, csrc/sweep_common.cuh) on its own, so that a check
can hold it against build.bf16_round, torch's rounding, which the plain
versions use. Nothing on the render path imports this module; its library
is built at the probe's first use.
"""
from __future__ import annotations

import ctypes

import torch

from .build import build_library

__all__ = ["round_weights_on_device"]

_lib = None


def round_weights_on_device(x):
    """x (a contiguous float32 CUDA tensor) rounded as the kernels round a
    tap weight in the bfloat16 stream mode, widened back to float32."""
    global _lib
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("round_weights_on_device: needs a contiguous "
                         f"float32 CUDA tensor, got {x.dtype} on {x.device}")
    if _lib is None:
        lib, _ = build_library("round_probe")
        lib.round_weights_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.round_weights_launch.restype = ctypes.c_int
        _lib = lib
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib.round_weights_launch(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"round_weights probe failed: CUDA error {rc}")
    return out
