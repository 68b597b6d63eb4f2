"""Backward slice sweep of the 4-channel reference medium: the binding of
the hand-written CUDA kernel csrc/sweep_ref_bwd.cu, in place of
volumetricrenderer_tpu/kernels/sweep_pallas.py's `_bwd_kernel_ref` /
`_run_bwd_ref`, and the kernel's plain PyTorch version
(sweep_ref_bwd_reference).

Both compute dL, the gradient of the base maps (acc, trans, wsum) with
respect to the pre-lerped channel slabs L (S, 4, A, B) that the forward
swept, from the maps' cotangents: the replay of the transmittance, the
single-channel backward's dsigma, the product rule of
sigma = (r0*r1)*(r2+r3)*sample_scale, and each channel's share scattered
through its own scaled, scrolled and mirrored taps. With light slabs they
also compute the slabs' gradient (the kernel's second output), through the
unscaled, clipped taps. The autograd node in
kernels/sweep_ref_fwd.py calls one or the other by device: CUDA slabs
launch the kernel (or raise), CPU slabs run the plain version. Plan arrays
and params get no gradient, as in the JAX package.

The kernel runs the forward's tiled schedule (csrc/sweep_ref_tile.cuh) and
sums each channel's share per run of lanes into per-warp shared windows;
`tiles` tallies its tile-slices as sweep_ref_fwd.tiles does.

`launches` counts the kernel launches made by this module.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.resample import linear_resample_matrix
from ..ops.sampling import clip_unit_grad
from .build import (N_PARAMS, NCH, TileTally, build_library,
                    channel_resample, check_sweep_inputs, light_sample,
                    ref_stage_cap, ref_stage_for)

__all__ = ["sweep_ref_bwd_reference", "build_kernel", "launch_kernel",
           "launches", "tiles"]

launches = 0  # kernel launches since import (or since a caller reset it)
tiles = TileTally()  # tile-slices (computed, read through global memory)

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output


@torch.no_grad()
def sweep_ref_bwd_reference(L, slice_z, v_grid, u_grid, seglen, params,
                            ct_acc, ct_trans, ct_wsum, trans, wsum, *,
                            emission: bool, light=None):
    """Plain PyTorch version of the backward kernel, with the same inputs.

    L, slice_z, v_grid, u_grid, seglen, params: the forward's inputs
    (kernels/sweep_ref_fwd.sweep_ref_fwd_reference); ct_acc, ct_trans,
    ct_wsum: the (Hb, Wb) cotangents of the acc, trans and wsum maps;
    trans, wsum: the forward's own maps. Emission reads ct_trans, ct_wsum,
    trans and wsum, absorption ct_acc; the others may be None. light: the
    optional (S, A, B) light slabs the forward read (emission only).
    Bfloat16 slabs are the bfloat16 stream mode, as in the forward: widened
    texels, every tap weight rounded to bfloat16, the scatter through the
    rounded matrices' transposes; dL and dlight are float32.

    It replays the forward per slice with the banded tap matrices, forms
    dsigma in closed form (sweep_pallas.py:2007-2027, not autograd of the
    forward), splits it by the product rule and scatters each channel's
    share through its matrices' transposes:
    dL[s, c] += Wa_c^T @ dr_c @ Wb_c. With light slabs the shade enters Wr
    and dsigma, and dlT = cw * T * alpha * (1 - ambient) * clip'(lT), with
    the hand-written clip' of the kernel, goes through the transposes of
    the unscaled clipped tap matrices into dlight[s]. Returns dL,
    (S, 4, A, B) float32; with light slabs, (dL, dlight)."""
    if light is not None and not emission:
        raise ValueError("sweep: a light volume needs emission")
    S, _, A, B = L.shape
    low = L.dtype == torch.bfloat16
    e_k, e_a, e_b, sign, density, sscale, thresh, ambient = (
        params[n] for n in range(8))
    dL = torch.zeros_like(L, dtype=torch.float32)
    dlight = (torch.zeros_like(light, dtype=torch.float32)
              if light is not None else None)
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
        mats = [channel_resample(a01, b01, params, c, A, B, low)
                for c in range(NCH)]
        r = [Wa @ L[s, c].to(torch.float32) @ Wbm.T
             for c, (Wa, Wbm) in enumerate(mats)]
        if emission:
            sigma = (r[0] * r[1]) * (r[2] + r[3]) * sscale * maskf
            live = (T > thresh).to(torch.float32)
            E = torch.exp(-density * sigma * seglen)
            alpha = live * (1.0 - E)
            shade = 1.0  # a product with 1.0 is exact: the no-light replay
            if light is not None:
                lT = light_sample(light[s], a01, b01, "clamp")
                shade = ambient + (1.0 - ambient) * torch.clamp(lT, 0.0, 1.0)
                dlT = cw * T * alpha * (1.0 - ambient) * clip_unit_grad(lT)
                dlight[s] += (
                    linear_resample_matrix(a01, A, "clamp",
                                           round_bf16=low).T @ dlT
                    @ linear_resample_matrix(b01, B, "clamp",
                                             round_bf16=low))
            Wr = Wr + T * alpha * shade
            A_til = bct - cw * Wr
            dsigma = live * density * seglen * (cw * T * shade * E - A_til)
            T = T * (1.0 - alpha)
        else:
            dsigma = ct_acc * seglen
        dsigma = dsigma * sscale * maskf
        s34 = r[2] + r[3]
        r01 = r[0] * r[1]
        dr = (dsigma * r[1] * s34, dsigma * r[0] * s34, dsigma * r01,
              dsigma * r01)
        for c, (Wa, Wbm) in enumerate(mats):
            dL[s, c] += Wa.T @ dr[c] @ Wbm
    return dL if light is None else (dL, dlight)


def build_kernel():
    """Build (at first use) and load the kernel's library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("sweep_ref_bwd")
        fn = lib.sweep_ref_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(L, slice_z, v_grid, u_grid, seglen, params, ct_acc,
                  ct_trans, ct_wsum, trans, wsum, *, emission: bool,
                  light=None, stage=None):
    """Check the inputs, allocate the zeroed (S, 4, A, B) gradient (and,
    with light slabs, their zeroed gradient), launch the kernel on the
    current stream and count the launch. Arguments as
    sweep_ref_bwd_reference's (L's dtype selects the kernel's
    instantiation); the maps a mode does not read may be None. `stage` as
    sweep_ref_fwd.launch_kernel's. Returns float32 dL, or (dL, dlight) with
    light slabs."""
    global launches
    dev = L.device
    if light is not None and not emission:
        raise ValueError("sweep_ref_bwd kernel: a light volume needs "
                         "emission")
    maps = (dict(ct_trans=ct_trans, ct_wsum=ct_wsum, trans=trans, wsum=wsum)
            if emission else dict(ct_acc=ct_acc))
    S, A, B, Hb, Wb, elem = check_sweep_inputs(
        "sweep_ref_bwd", L, slice_z, v_grid, u_grid, seglen, params, maps,
        channels=NCH, n_params=N_PARAMS, light=light)
    build_kernel()
    if stage is None:
        stage = ref_stage_for(slice_z, v_grid, u_grid, params, A, B,
                              light=light is not None)
    cap = ref_stage_cap(stage, True, light is not None)

    def ptr(name):
        return maps[name].data_ptr() if name in maps else None

    dL = torch.zeros((S, NCH, A, B), dtype=torch.float32, device=dev)
    dlight = (torch.zeros_like(light, dtype=torch.float32)
              if light is not None else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.sweep_ref_bwd_launch(
            L.data_ptr(), light.data_ptr() if light is not None else None,
            slice_z.data_ptr(), v_grid.data_ptr(), u_grid.data_ptr(),
            seglen.data_ptr(), params.data_ptr(), ptr("ct_acc"),
            ptr("ct_trans"), ptr("ct_wsum"), ptr("trans"), ptr("wsum"),
            dL.data_ptr(),
            dlight.data_ptr() if light is not None else None, S, A, B, Hb,
            Wb, int(emission), elem, cap, tiles.tensor(dev).data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"sweep_ref_bwd kernel launch failed: CUDA error {rc}")
    launches += 1
    return dL if light is None else (dL, dlight)
