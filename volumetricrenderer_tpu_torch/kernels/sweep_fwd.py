"""Forward slice sweep: the wrapper in place of
volumetricrenderer_tpu/kernels/sweep_pallas.py's sweep_base_pallas, its
hand-written CUDA kernel (csrc/sweep_fwd.cu) and the kernel's plain PyTorch
version (sweep_fwd_reference).

`sweep_base` runs the sweep as one autograd node on either device: on a
CUDA tensor its forward launches this kernel and its backward the
backward kernel of kernels/sweep_bwd.py (the port of sweep_pallas.py's
`_bwd_kernel`), or they raise; on a CPU tensor they run the two plain
versions, sweep_fwd_reference and sweep_bwd.sweep_bwd_reference. There is
no fallback from one device's path to the other's.

`launches` counts the kernel launches made by this module.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import LightConfig, MediumConfig, RenderConfig
from ..ops.resample import linear_resample_matrix
from ..ops.sampling import apply_address_mode
from . import sweep_bwd
from .build import build_library, check_sweep_inputs

__all__ = ["supported", "sweep_inputs", "sweep_base", "sweep_fwd_reference",
           "build_kernel", "launch_kernel", "launches"]

launches = 0  # kernel launches since import (or since a caller reset it)

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output

_ADDRESS_MODES = ("mirror", "clamp", "wrap")


def supported(cfg: RenderConfig, medium: MediumConfig, light_volume,
              scroll, grid_ndim: int) -> bool:
    """Configurations the kernel (and its plain version) cover. Unlike the
    TPU gate, the base grid needs no 128-multiple tiling."""
    return (medium.combine == "single"
            and cfg.dtype == "float32"
            and grid_ndim == 3
            and scroll is None
            and light_volume is None
            and cfg.address_mode in _ADDRESS_MODES)


def _params_for(plan, cfg: RenderConfig, medium: MediumConfig,
                light: LightConfig) -> torch.Tensor:
    """(8,) float32: e_k, e_a, e_b, sign, density, sample_scale,
    early-stop transmittance, ambient — the TPU kernels' params layout."""
    rest = torch.tensor([plan.sign, medium.density, medium.sample_scale,
                         cfg.early_stop_transmittance, light.ambient],
                        dtype=torch.float32, device=plan.eye01.device)
    return torch.cat([plan.eye01.to(torch.float32), rest])


def _layer_lerp_stack(gperm, slice_z, address_mode):
    """Lerp the (D, A, B) volume onto the S slice planes: out[s] is the
    volume at normalized sweep coord slice_z[s] (texel-center lerp between
    the two bracketing layers). Differentiable in gperm."""
    depth = gperm.shape[0]
    p = slice_z * depth - 0.5
    i0f = torch.floor(p)
    f = (p - i0f).to(torch.float32)[:, None, None]
    i0 = i0f.to(torch.int64)
    g0 = gperm[apply_address_mode(i0, depth, address_mode)]
    g1 = gperm[apply_address_mode(i0 + 1, depth, address_mode)]
    return g0 + f * (g1 - g0)


def sweep_fwd_reference(stack, slice_z, v_grid, u_grid, seglen, params, *,
                        emission: bool, flip: bool, address_mode: str):
    """Plain PyTorch version of the sweep kernel, with the same inputs.

    stack: (S, A, B) float32, slice k = S-1-s feeds slice s when flip;
    slice_z (S,), v_grid (Hb,), u_grid (Wb,), seglen (Hb, Wb), params (8,)
    as _params_for. Each slice is resampled as Wa @ G_k @ Wb^T with banded
    tap matrices; out-of-box and behind-the-eye samples are masked.
    Returns (acc, trans, wsum, hit), each (Hb, Wb) float32."""
    S, A, B = stack.shape
    Hb, Wb = v_grid.shape[0], u_grid.shape[0]
    e_k, e_a, e_b, sign, density, sscale, thresh = (params[n]
                                                    for n in range(7))
    kw = dict(dtype=torch.float32, device=stack.device)
    acc = torch.zeros((Hb, Wb), **kw)
    trans = torch.ones((Hb, Wb), **kw)
    wsum = torch.zeros((Hb, Wb), **kw)
    hit = torch.zeros((Hb, Wb), **kw)
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
        g = stack[S - 1 - s if flip else s]
        sigma = (Wa @ g @ Wbm.T) * sscale * maskf
        if emission:
            live = (trans > thresh).to(torch.float32)
            alpha = live * (1.0 - torch.exp(-density * sigma * seglen))
            wsum = wsum + trans * alpha
            trans = trans * (1.0 - alpha)
        else:
            acc = acc + sigma * seglen
            hit = torch.maximum(hit, maskf)
    return acc, trans, wsum, hit


def build_kernel():
    """Build (at first use) and load the kernel's library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("sweep_fwd")
        fn = lib.sweep_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(stack, slice_z, v_grid, u_grid, seglen, params, emission,
                  flip, wrap):
    """Check the inputs, allocate the (4, Hb, Wb) output, launch the
    kernel on the current stream and count the launch. Returns the
    (4, Hb, Wb) tensor of acc, trans, wsum, hit."""
    global launches
    dev = stack.device
    S, A, B, Hb, Wb = check_sweep_inputs("sweep_fwd", stack, slice_z, v_grid,
                                         u_grid, seglen, params)
    build_kernel()
    out = torch.empty((4, Hb, Wb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.sweep_fwd_launch(
            stack.data_ptr(), slice_z.data_ptr(), v_grid.data_ptr(),
            u_grid.data_ptr(), seglen.data_ptr(), params.data_ptr(),
            out.data_ptr(), S, A, B, Hb, Wb, int(emission), int(flip),
            int(wrap), stream)
    if rc != 0:
        raise RuntimeError(f"sweep_fwd kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


class _SweepFwd(torch.autograd.Function):
    """The sweep as an autograd node, in place of _fused_vjp's f_fwd and
    f_bwd: the kernels on a CUDA stack, the plain versions on a CPU stack.
    Only the stack gets a gradient; `hit` is not differentiable."""

    @staticmethod
    def forward(ctx, stack, slice_z, v_grid, u_grid, seglen, params,
                emission, flip, address_mode):
        if stack.device.type == "cuda":
            maps = launch_kernel(stack, slice_z, v_grid, u_grid, seglen,
                                 params, emission, flip,
                                 address_mode == "wrap").unbind(0)
        elif stack.device.type == "cpu":
            maps = sweep_fwd_reference(stack, slice_z, v_grid, u_grid,
                                       seglen, params, emission=emission,
                                       flip=flip, address_mode=address_mode)
        else:
            raise ValueError(f"sweep: no kernel for device {stack.device}")
        ctx.mark_non_differentiable(maps[3])
        ctx.save_for_backward(stack, slice_z, v_grid, u_grid, seglen, params,
                              maps[1], maps[2])
        ctx.static = (emission, flip, address_mode)
        return tuple(maps)

    @staticmethod
    def backward(ctx, ct_acc, ct_trans, ct_wsum, _ct_hit):
        none = (None,) * 8
        if not ctx.needs_input_grad[0]:
            return (None,) + none
        stack, slice_z, v_grid, u_grid, seglen, params, trans, wsum = \
            ctx.saved_tensors
        emission, flip, address_mode = ctx.static
        # Cotangents may arrive broadcast (the gradient of a sum); the
        # kernel reads dense maps.
        cts = [c.contiguous() for c in (ct_acc, ct_trans, ct_wsum)]
        if stack.device.type == "cuda":
            dstack = sweep_bwd.launch_kernel(
                stack, slice_z, v_grid, u_grid, seglen, params, *cts, trans,
                wsum, emission, flip, address_mode == "wrap")
        else:
            dstack = sweep_bwd.sweep_bwd_reference(
                stack, slice_z, v_grid, u_grid, seglen, params, *cts, trans,
                wsum, emission=emission, flip=flip,
                address_mode=address_mode)
        return (dstack,) + none


def sweep_inputs(gperm, plan, cfg: RenderConfig, medium: MediumConfig,
                 light=None):
    """The kernel's inputs for a grid permuted so the sweep axis is dim 0
    (grid.permute(plan.perm)): ((stack, slice_z, v_grid, u_grid, seglen,
    params), flip).

    With n_slices != depth the volume is first lerped onto the slice planes
    (that stack is already in slice order, so no flip); otherwise the
    kernel reads the grid's layers mirrored when plan.sign < 0."""
    lt = light if light is not None else LightConfig()
    params = _params_for(plan, cfg, medium, lt)
    if plan.slice_z.shape[0] != gperm.shape[0]:
        stack = _layer_lerp_stack(gperm, plan.slice_z, cfg.address_mode)
        flip = False
    else:
        stack, flip = gperm, plan.sign < 0
    return (stack, plan.slice_z, plan.v_grid, plan.u_grid, plan.seglen,
            params), flip


def sweep_base(gperm, plan, cfg: RenderConfig, medium: MediumConfig,
               light=None):
    """(acc, trans, wsum, hit) base maps, each (Hb, Wb) float32, for a
    grid permuted so the sweep axis is dim 0: the kernels for a CUDA grid,
    the plain versions for a CPU grid, differentiable in the grid either
    way."""
    (stack, *args), flip = sweep_inputs(gperm, plan, cfg, medium, light)
    if stack.device.type == "cuda":
        # The kernel reads a dense stack; autograd carries dG back through
        # this copy (and through the permute) to the grid.
        stack = stack.contiguous()
    elif stack.device.type != "cpu":
        raise ValueError(f"sweep_base: no sweep for device {stack.device}")
    return _SweepFwd.apply(stack, *args, cfg.emission, flip,
                           cfg.address_mode)
