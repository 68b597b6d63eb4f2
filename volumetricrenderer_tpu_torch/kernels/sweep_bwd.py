"""Backward slice sweep: the binding of the hand-written CUDA kernel
csrc/sweep_bwd.cu, in place of volumetricrenderer_tpu/kernels/sweep_pallas.py's
K2 (`_bwd_kernel` / `_run_bwd`), and the kernel's plain PyTorch version
(sweep_bwd_reference).

Both compute dG, the gradient of the base maps (acc, trans, wsum) with
respect to the (S, A, B) stack the forward swept, from the maps'
cotangents: the closed-form replay of K2 with no light volume. The
autograd node in kernels/sweep_fwd.py calls one or the other by device: a
CUDA stack launches the kernel (or raises), a CPU stack runs the plain
version. Plan arrays and params get no gradient, as in the JAX package;
`hit` is not differentiable.

`launches` counts the kernel launches made by this module.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.resample import linear_resample_matrix
from .build import build_library, check_sweep_inputs

__all__ = ["sweep_bwd_reference", "build_kernel", "launch_kernel",
           "launches"]

launches = 0  # kernel launches since import (or since a caller reset it)

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output


@torch.no_grad()
def sweep_bwd_reference(stack, slice_z, v_grid, u_grid, seglen, params,
                        ct_acc, ct_trans, ct_wsum, trans, wsum, *,
                        emission: bool, flip: bool, address_mode: str):
    """Plain PyTorch version of the backward kernel, with the same inputs.

    stack, slice_z, v_grid, u_grid, seglen, params: the forward's inputs
    (kernels/sweep_fwd.sweep_fwd_reference); ct_acc, ct_trans, ct_wsum:
    the (Hb, Wb) cotangents of the acc, trans and wsum maps; trans, wsum:
    the forward's own maps. Emission reads ct_trans, ct_wsum, trans and
    wsum, absorption ct_acc; the others may be None.

    It replays the forward per slice with the banded tap matrices and
    scatters dsigma * sample_scale through their transposes:
    dG[k] += Wa^T @ (dsigma * sample_scale * mask) @ Wb. This is the
    closed form of K2 (sweep_pallas.py:1204-1222 with shade = 1), not
    autograd of the forward. Returns dG, (S, A, B) float32, in the stack's
    layer order (slice s feeds layer S-1-s when flip)."""
    S, A, B = stack.shape
    e_k, e_a, e_b, sign, density, sscale, thresh = (params[n]
                                                    for n in range(7))
    dG = torch.zeros((S, A, B), dtype=torch.float32, device=stack.device)
    if emission:
        cw = ct_wsum
        bct = ct_trans * trans + cw * wsum
        T = torch.ones_like(seglen)
        Wr = torch.zeros_like(seglen)
    for s in range(S):
        delta = slice_z[s] - e_k
        a01 = e_a + delta * v_grid
        b01 = e_b + delta * u_grid
        front = (delta * sign) > 0.0
        mask = ((a01 >= 0.0) & (a01 <= 1.0))[:, None] \
            & ((b01 >= 0.0) & (b01 <= 1.0))[None, :] & front
        maskf = mask.to(torch.float32)
        Wa = linear_resample_matrix(a01, A, address_mode)
        Wbm = linear_resample_matrix(b01, B, address_mode)
        k = S - 1 - s if flip else s
        if emission:
            sigma = (Wa @ stack[k] @ Wbm.T) * sscale * maskf
            live = (T > thresh).to(torch.float32)
            E = torch.exp(-density * sigma * seglen)
            alpha = live * (1.0 - E)
            Wr = Wr + T * alpha
            A_til = bct - cw * Wr
            dsigma = live * density * seglen * (cw * T * E - A_til)
            T = T * (1.0 - alpha)
        else:
            dsigma = ct_acc * seglen
        dG[k] += Wa.T @ (dsigma * sscale * maskf) @ Wbm
    return dG


def build_kernel():
    """Build (at first use) and load the kernel's library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("sweep_bwd")
        fn = lib.sweep_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(stack, slice_z, v_grid, u_grid, seglen, params, ct_acc,
                  ct_trans, ct_wsum, trans, wsum, emission, flip, wrap):
    """Check the inputs, allocate the zeroed (S, A, B) gradient, launch the
    kernel on the current stream and count the launch. Arguments as
    sweep_bwd_reference's; the maps a mode does not read may be None.
    Returns dG."""
    global launches
    dev = stack.device
    maps = (dict(ct_trans=ct_trans, ct_wsum=ct_wsum, trans=trans, wsum=wsum)
            if emission else dict(ct_acc=ct_acc))
    S, A, B, Hb, Wb = check_sweep_inputs("sweep_bwd", stack, slice_z, v_grid,
                                         u_grid, seglen, params, maps)
    build_kernel()

    def ptr(name):
        return maps[name].data_ptr() if name in maps else None

    dstack = torch.zeros((S, A, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.sweep_bwd_launch(
            stack.data_ptr(), slice_z.data_ptr(), v_grid.data_ptr(),
            u_grid.data_ptr(), seglen.data_ptr(), params.data_ptr(),
            ptr("ct_acc"), ptr("ct_trans"), ptr("ct_wsum"), ptr("trans"),
            ptr("wsum"), dstack.data_ptr(), S, A, B, Hb, Wb, int(emission),
            int(flip), int(wrap), stream)
    if rc != 0:
        raise RuntimeError(f"sweep_bwd kernel launch failed: CUDA error {rc}")
    launches += 1
    return dstack
