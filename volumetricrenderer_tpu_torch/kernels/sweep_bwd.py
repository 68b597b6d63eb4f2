"""Backward slice sweep: the binding of the hand-written CUDA kernel
csrc/sweep_bwd.cu, in place of volumetricrenderer_tpu/kernels/sweep_pallas.py's
K2 (`_bwd_kernel` / `_run_bwd`), and the kernel's plain PyTorch version
(sweep_bwd_reference).

Both compute dG, the gradient of the base maps (acc, trans, wsum) with
respect to the (S, A, B) stack the forward swept, from the maps'
cotangents: the closed-form replay of K2. With a light stack they also
compute dL, the gradient with respect to it (K2's second output). The
autograd node in kernels/sweep_fwd.py calls one or the other by device: a
CUDA stack launches the kernel (or raises), a CPU stack runs the plain
version. Plan arrays and params get no gradient, as in the JAX package;
`hit` is not differentiable.

The kernel runs K1's tiled schedule (csrc/sweep_tile.cuh) and sums each
tile-slice's dG (and dL) in shared memory, per warp, before adding it to the
gradient; `tiles` tallies its tile-slices as kernels/sweep_fwd.py's does.

`launches` counts the kernel launches made by this module.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.resample import linear_resample_matrix
from ..ops.sampling import clip_unit_grad
from ..utils import clock
from .build import (TileTally, build_library, check_sweep_inputs,
                    light_sample, stage_buffers, stage_cap, stage_for)

__all__ = ["sweep_bwd_reference", "build_kernel", "launch_kernel",
           "launches", "tiles"]

launches = 0  # kernel launches since import (or since a caller reset it)
tiles = TileTally()  # tile-slices (computed, read through global memory)

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output


@torch.no_grad()
def sweep_bwd_reference(stack, slice_z, v_grid, u_grid, seglen, params,
                        ct_acc, ct_trans, ct_wsum, trans, wsum, *,
                        emission: bool, flip: bool, address_mode: str,
                        light=None):
    """Plain PyTorch version of the backward kernel, with the same inputs.

    stack, slice_z, v_grid, u_grid, seglen, params: the forward's inputs
    (kernels/sweep_fwd.sweep_fwd_reference); ct_acc, ct_trans, ct_wsum:
    the (Hb, Wb) cotangents of the acc, trans and wsum maps; trans, wsum:
    the forward's own maps. Emission reads ct_trans, ct_wsum, trans and
    wsum, absorption ct_acc; the others may be None. light: the optional
    (S, A, B) light stack the forward read (emission only). A bfloat16
    stack (and light stack) is the bfloat16 stream mode, as in the forward:
    widened texels, tap weights rounded to bfloat16, and the transposes
    that scatter are those rounded matrices'; dG and dL are float32.

    It replays the forward per slice with the banded tap matrices and
    scatters dsigma * sample_scale through their transposes:
    dG[k] += Wa^T @ (dsigma * sample_scale * mask) @ Wb. This is the
    closed form of K2 (sweep_pallas.py:1204-1222), not autograd of the
    forward. With a light stack the shade enters Wr and dsigma, and
    dlT = cw * T * alpha * (1 - ambient) * clip'(lT), with K2's hand-written
    clip' (1 inside (0, 1), 0.5 at 0 and at 1, 0 outside), goes through the
    same transposes into dL[k]. Returns dG, (S, A, B) float32, in the
    stack's layer order (slice s feeds layer S-1-s when flip); with a light
    stack, (dG, dL)."""
    if light is not None and not emission:
        raise ValueError("sweep: a light volume needs emission")
    S, A, B = stack.shape
    low = stack.dtype == torch.bfloat16
    e_k, e_a, e_b, sign, density, sscale, thresh, ambient = (
        params[n] for n in range(8))
    dG = torch.zeros((S, A, B), dtype=torch.float32, device=stack.device)
    dLt = torch.zeros_like(dG) if light is not None else None
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
        Wa = linear_resample_matrix(a01, A, address_mode, round_bf16=low)
        Wbm = linear_resample_matrix(b01, B, address_mode, round_bf16=low)
        k = S - 1 - s if flip else s
        if emission:
            sigma = (Wa @ stack[k].to(torch.float32) @ Wbm.T) * sscale \
                * maskf
            live = (T > thresh).to(torch.float32)
            E = torch.exp(-density * sigma * seglen)
            alpha = live * (1.0 - E)
            shade = 1.0  # a product with 1.0 is exact: the no-light replay
            if light is not None:
                lT = light_sample(light[k], a01, b01, address_mode)
                shade = ambient + (1.0 - ambient) * torch.clamp(lT, 0.0, 1.0)
                dlT = cw * T * alpha * (1.0 - ambient) * clip_unit_grad(lT)
                dLt[k] += Wa.T @ dlT @ Wbm
            Wr = Wr + T * alpha * shade
            A_til = bct - cw * Wr
            dsigma = live * density * seglen * (cw * T * shade * E - A_til)
            T = T * (1.0 - alpha)
        else:
            dsigma = ct_acc * seglen
        dG[k] += Wa.T @ (dsigma * sscale * maskf) @ Wbm
    return dG if light is None else (dG, dLt)


def build_kernel():
    """Build (at first use) and load the kernel's library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("sweep_bwd")
        fn = lib.sweep_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(stack, slice_z, v_grid, u_grid, seglen, params, ct_acc,
                  ct_trans, ct_wsum, trans, wsum, emission, flip, wrap,
                  light=None, stage=None):
    """Check the inputs, allocate the zeroed (S, A, B) gradient (and, with
    a light stack, its zeroed gradient), launch the kernel on the current
    stream and count the launch. Arguments as sweep_bwd_reference's (the
    stack's dtype selects the kernel's instantiation); the maps a mode does
    not read may be None. `stage` as sweep_fwd.launch_kernel's. Returns
    float32 dG, or (dG, dL) with a light stack. Span "sweep.bwd" (the host
    side of the launch)."""
    global launches
    with clock.span("sweep.bwd"):
        dev = stack.device
        if light is not None and not emission:
            raise ValueError("sweep_bwd kernel: a light volume needs emission")
        maps = (dict(ct_trans=ct_trans, ct_wsum=ct_wsum, trans=trans,
                     wsum=wsum)
                if emission else dict(ct_acc=ct_acc))
        S, A, B, Hb, Wb, elem = check_sweep_inputs(
            "sweep_bwd", stack, slice_z, v_grid, u_grid, seglen, params, maps,
            light=light)
        build_kernel()
        if stage is None:
            stage = stage_for(slice_z, v_grid, u_grid, params, A, B, wrap)
        cap = stage_cap(stage, stage_buffers(True, light is not None))

        def ptr(name):
            return maps[name].data_ptr() if name in maps else None

        dstack = torch.zeros((S, A, B), dtype=torch.float32, device=dev)
        dlight = torch.zeros_like(dstack) if light is not None else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib.sweep_bwd_launch(
                stack.data_ptr(),
                light.data_ptr() if light is not None else None,
                slice_z.data_ptr(), v_grid.data_ptr(), u_grid.data_ptr(),
                seglen.data_ptr(), params.data_ptr(), ptr("ct_acc"),
                ptr("ct_trans"), ptr("ct_wsum"), ptr("trans"), ptr("wsum"),
                dstack.data_ptr(),
                dlight.data_ptr() if light is not None else None, S, A, B, Hb,
                Wb, int(emission), int(flip), int(wrap), elem, cap,
                tiles.tensor(dev).data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                f"sweep_bwd kernel launch failed: CUDA error {rc}")
        launches += 1
        return dstack if light is None else (dstack, dlight)
