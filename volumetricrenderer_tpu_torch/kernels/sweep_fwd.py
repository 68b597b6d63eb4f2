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

With a light-transmittance volume (ops/lighting.py) in the grid's layout
the emission sweep shades every sample: shade = ambient + (1 - ambient) *
clip(lT, 0, 1), lT the light layer's bilinear sample at the grid's own
taps, wsum += T * alpha * shade. The node then has two differentiable
inputs, the stack and the light stack.

The bfloat16 stream mode (RenderConfig(dtype="bfloat16"), the TPU kernels'
`low` mode) is defined for all four sweep kernels and their plain versions
as follows. Every texel a kernel reads (the grid stack, the light stack,
the 4-channel slabs L, the light slabs) is the float32 value rounded to
bfloat16, ties to even, stored as torch.bfloat16 and read as 2-byte
elements. Every bilinear tap weight (1 - fa, fa, 1 - fb, fb, and each
channel's own in the 4-channel kernels) is rounded to bfloat16 too, each on
its own. Products and sums, the carries (acc, T, wsum, hit), exp, the
early-stop gate, the cotangents, dsigma and the scattered gradients stay
float32; a sample is the four-tap sum in float32 of bfloat16 operands, in
the order csrc/sweep_common.cuh's bilinear_at fixes, and the adjoint
scatters with the rounded weights. (The JAX package also rounds the
intermediate between its two matmuls; that belongs to its two-matmul
schedule, differs between its kernels and its jnp sweep, and is not
reproduced.) The cast lives inside the autograd nodes: a node takes the
float32 stack, makes the bfloat16 copy, sweeps it, saves that copy for the
backward (half the bytes, and the very texels the forward read) and returns
a float32 gradient; with n_slices != depth the layer lerp runs in float32
first. A stack that arrives in bfloat16 is swept without a copy and gets a
bfloat16 gradient. The plain versions take the mode from the stack's dtype,
as the kernels' launchers do.

The kernel's schedule (csrc/sweep_tile.cuh) tiles the base grid and stages
each tile-slice's tap window in shared memory; the host sizes that stage
from the plan (build.stage_for, once per plan) and `tiles` tallies the
tile-slices the kernel computed and those it read through global memory
because their window exceeded the stage.

`launches` counts the kernel launches made by this module.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import LightConfig, MediumConfig, RenderConfig
from ..ops.resample import linear_resample_matrix
from ..ops.sampling import apply_address_mode, clip_unit
from ..utils import clock
from . import sweep_bwd
from .build import (IdentityCache, TileTally, build_library,
                    check_sweep_inputs, light_sample, stage_buffers,
                    stage_cap, stage_for, stream_cast)

__all__ = ["supported", "sweep_inputs", "sweep_light_stack", "sweep_base",
           "sweep_fwd_reference", "build_kernel", "launch_kernel",
           "launches", "tiles"]

launches = 0  # kernel launches since import (or since a caller reset it)
tiles = TileTally()  # tile-slices (computed, read through global memory)

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output

_ADDRESS_MODES = ("mirror", "clamp", "wrap")
_DTYPES = ("float32", "bfloat16")


def supported(cfg: RenderConfig, medium: MediumConfig, light_volume,
              scroll, grid_ndim: int) -> bool:
    """Configurations the sweep kernels (and their plain versions) cover.
    Unlike the TPU gate, the base grid needs no 128-multiple tiling.

    combine="reference" (kernels/sweep_ref_fwd.py): a 4-D grid, mirror
    addressing (the scaled and scrolled coords leave [0, 1]); a scroll is
    allowed. combine="single" (this module): a 3-D grid, no scroll
    (ops/sweep.sweep_render brings a (D, H, W, C) grid and a scroll to that
    form first). A light volume must be 3-D and needs emission. Both
    stream types, as the TPU gate."""
    light_ok = light_volume is None or (cfg.emission
                                        and light_volume.dim() == 3)
    if medium.combine == "reference":
        return (cfg.dtype in _DTYPES
                and grid_ndim == 4
                and light_ok
                and cfg.address_mode == "mirror")
    return (medium.combine == "single"
            and cfg.dtype in _DTYPES
            and grid_ndim == 3
            and scroll is None
            and light_ok
            and cfg.address_mode in _ADDRESS_MODES)


_PARAMS = IdentityCache()


def _params_for(plan, cfg: RenderConfig, medium: MediumConfig,
                light: LightConfig) -> torch.Tensor:
    """(8,) float32: e_k, e_a, e_b, sign, density, sample_scale,
    early-stop transmittance, ambient — the TPU kernels' params layout.
    One tensor per plan and values, so the stage sized from it (build.
    stage_for) is sized once per plan."""
    values = (plan.sign, medium.density, medium.sample_scale,
              cfg.early_stop_transmittance, light.ambient)

    def make():
        rest = torch.tensor(values, dtype=torch.float32,
                            device=plan.eye01.device)
        return torch.cat([plan.eye01.to(torch.float32), rest])
    return _PARAMS.get((plan.eye01,), values, make)


def _layer_lerp_stack(gperm, slice_z, address_mode):
    """Lerp the (D, A, B) volume onto the S slice planes: out[s] is the
    volume at normalized sweep coord slice_z[s] (texel-center lerp between
    the two bracketing layers). Differentiable in gperm; the layer fetch is
    index_select, whose backward is index_add_."""
    depth = gperm.shape[0]
    gperm = gperm.to(torch.float32)  # a bfloat16 volume lerps in float32
    p = slice_z * depth - 0.5
    i0f = torch.floor(p)
    f = (p - i0f).to(torch.float32)[:, None, None]
    i0 = i0f.to(torch.int64)
    g0 = torch.index_select(
        gperm, 0, apply_address_mode(i0, depth, address_mode))
    g1 = torch.index_select(
        gperm, 0, apply_address_mode(i0 + 1, depth, address_mode))
    return g0 + f * (g1 - g0)


def sweep_fwd_reference(stack, slice_z, v_grid, u_grid, seglen, params, *,
                        emission: bool, flip: bool, address_mode: str,
                        light=None, _low=None):
    """Plain PyTorch version of the sweep kernel, with the same inputs.

    stack: (S, A, B) float32 or bfloat16, slice k = S-1-s feeds slice s
    when flip; slice_z (S,), v_grid (Hb,), u_grid (Wb,), seglen (Hb, Wb),
    params (8,) as _params_for; light: optional (S, A, B)
    light-transmittance stack in the stack's layer order and dtype
    (emission only). Each slice is resampled as Wa @ G_k @ Wb^T with banded
    tap matrices, the light layer at the same taps (build.light_sample);
    out-of-box and behind-the-eye samples are masked. A bfloat16 stack is
    the bfloat16 stream mode: the texels widened to float32, the matrices'
    tap weights rounded to bfloat16, float32 products. The private
    _low=True forces that arithmetic on float32 stacks (which then hold
    bfloat16 values): autograd through a bfloat16 tensor would round the
    gradient, so the tests differentiate this form.
    Returns (acc, trans, wsum, hit), each (Hb, Wb) float32."""
    if light is not None and not emission:
        raise ValueError("sweep: a light volume needs emission")
    S, A, B = stack.shape
    low = stack.dtype == torch.bfloat16 if _low is None else _low
    Hb, Wb = v_grid.shape[0], u_grid.shape[0]
    e_k, e_a, e_b, sign, density, sscale, thresh, ambient = (
        params[n] for n in range(8))
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
        Wa = linear_resample_matrix(a01, A, address_mode, round_bf16=low)
        Wbm = linear_resample_matrix(b01, B, address_mode, round_bf16=low)
        k = S - 1 - s if flip else s
        sigma = (Wa @ stack[k].to(torch.float32) @ Wbm.T) * sscale * maskf
        if emission:
            live = (trans > thresh).to(torch.float32)
            alpha = live * (1.0 - torch.exp(-density * sigma * seglen))
            shade = 1.0  # a product with 1.0 is exact: the no-light sum
            if light is not None:
                lT = light_sample(light[k], a01, b01, address_mode, low)
                shade = ambient + (1.0 - ambient) * clip_unit(lT)
            wsum = wsum + trans * alpha * shade
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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(stack, slice_z, v_grid, u_grid, seglen, params, emission,
                  flip, wrap, light=None, stage=None):
    """Check the inputs, allocate the (4, Hb, Wb) output, launch the
    kernel on the current stream and count the launch. `stack` is float32
    or bfloat16 (the stream mode: it selects the kernel's instantiation).
    `light` is the optional (S, A, B) light stack in the stack's layer
    order and dtype (emission only): it selects the kernel's light branch.
    v_grid and u_grid must be monotone, as plan_sweep makes them. `stage`:
    texel slots per window buffer; None sizes it from the plan
    (build.stage_for), 0 reads every tile-slice through global memory.
    Returns the (4, Hb, Wb) float32 tensor of acc, trans, wsum, hit.
    Span "sweep.fwd" (the host side of the launch)."""
    global launches
    with clock.span("sweep.fwd"):
        dev = stack.device
        if light is not None and not emission:
            raise ValueError("sweep_fwd kernel: a light volume needs emission")
        S, A, B, Hb, Wb, elem = check_sweep_inputs(
            "sweep_fwd", stack, slice_z, v_grid, u_grid, seglen, params,
            light=light)
        build_kernel()
        if stage is None:
            stage = stage_for(slice_z, v_grid, u_grid, params, A, B, wrap)
        cap = stage_cap(stage, stage_buffers(False, light is not None))
        out = torch.empty((4, Hb, Wb), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib.sweep_fwd_launch(
                stack.data_ptr(),
                light.data_ptr() if light is not None else None,
                slice_z.data_ptr(), v_grid.data_ptr(), u_grid.data_ptr(),
                seglen.data_ptr(), params.data_ptr(), out.data_ptr(), S, A, B,
                Hb, Wb, int(emission), int(flip), int(wrap), elem, cap,
                tiles.tensor(dev).data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                f"sweep_fwd kernel launch failed: CUDA error {rc}")
        launches += 1
        return out


class _SweepFwd(torch.autograd.Function):
    """The sweep as an autograd node, in place of _fused_vjp's f_fwd and
    f_bwd (and, with a light stack, of its two-input instance): the
    kernels on a CUDA stack, the plain versions on a CPU stack. The stack
    and the light stack (or None) get gradients; `hit` is not
    differentiable. `low` is the bfloat16 stream mode: the node casts the
    stacks it is given to the stream type (a no-op for a stack already in
    it), sweeps and saves the cast stacks, and returns each gradient,
    computed in float32, in its input's dtype."""

    @staticmethod
    def forward(ctx, stack, light, slice_z, v_grid, u_grid, seglen, params,
                emission, flip, address_mode, low):
        ctx.in_dtypes = (stack.dtype, None if light is None else light.dtype)
        stack, light = stream_cast(stack, low), stream_cast(light, low)
        if stack.device.type == "cuda":
            maps = launch_kernel(stack, slice_z, v_grid, u_grid, seglen,
                                 params, emission, flip,
                                 address_mode == "wrap", light).unbind(0)
        elif stack.device.type == "cpu":
            maps = sweep_fwd_reference(stack, slice_z, v_grid, u_grid,
                                       seglen, params, emission=emission,
                                       flip=flip, address_mode=address_mode,
                                       light=light)
        else:
            raise ValueError(f"sweep: no kernel for device {stack.device}")
        ctx.mark_non_differentiable(maps[3])
        ctx.save_for_backward(stack, slice_z, v_grid, u_grid, seglen, params,
                              maps[1], maps[2], light)
        ctx.static = (emission, flip, address_mode)
        return tuple(maps)

    @staticmethod
    def backward(ctx, ct_acc, ct_trans, ct_wsum, _ct_hit):
        none = (None,) * 9
        if not any(ctx.needs_input_grad[:2]):
            return (None, None) + none
        stack, slice_z, v_grid, u_grid, seglen, params, trans, wsum, light = \
            ctx.saved_tensors
        emission, flip, address_mode = ctx.static
        # Cotangents may arrive broadcast (the gradient of a sum); the
        # kernel reads dense maps.
        cts = [c.contiguous() for c in (ct_acc, ct_trans, ct_wsum)]
        if stack.device.type == "cuda":
            grads = sweep_bwd.launch_kernel(
                stack, slice_z, v_grid, u_grid, seglen, params, *cts, trans,
                wsum, emission, flip, address_mode == "wrap", light=light)
        else:
            grads = sweep_bwd.sweep_bwd_reference(
                stack, slice_z, v_grid, u_grid, seglen, params, *cts, trans,
                wsum, emission=emission, flip=flip,
                address_mode=address_mode, light=light)
        dstack, dlight = grads if light is not None else (grads, None)
        dstack = dstack.to(ctx.in_dtypes[0])
        if dlight is not None:
            dlight = dlight.to(ctx.in_dtypes[1])
        return (dstack, dlight) + none


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


def sweep_light_stack(lperm, plan, cfg: RenderConfig):
    """The kernel's light stack for a light volume permuted like the grid
    (light_volume.permute(plan.perm), the grid's spatial shape): lerped
    onto the slice planes with the grid when n_slices != depth, else the
    volume itself, read at the grid's own (mirrored when flip) layer."""
    if plan.slice_z.shape[0] != lperm.shape[0]:
        return _layer_lerp_stack(lperm, plan.slice_z, cfg.address_mode)
    return lperm


def sweep_base(gperm, plan, cfg: RenderConfig, medium: MediumConfig,
               light=None, lperm=None):
    """(acc, trans, wsum, hit) base maps, each (Hb, Wb) float32, for a
    grid permuted so the sweep axis is dim 0: the kernels for a CUDA grid,
    the plain versions for a CPU grid, differentiable in the grid either
    way. lperm: optional light-transmittance volume in the same layout
    (emission only); the maps are differentiable in it too. cfg.dtype
    "bfloat16" sweeps in the bfloat16 stream mode (module docstring)."""
    low = cfg.dtype == "bfloat16"
    (stack, *args), flip = sweep_inputs(gperm, plan, cfg, medium, light)
    lstack = None
    if lperm is not None:
        if lperm.shape != gperm.shape:
            raise ValueError(
                f"sweep_base: the light volume must have the grid's shape "
                f"{tuple(gperm.shape)}, got {tuple(lperm.shape)}")
        lstack = sweep_light_stack(lperm, plan, cfg)
    if stack.device.type == "cuda":
        # The kernel reads dense stacks; autograd carries dG (and dL) back
        # through these copies (and through the permutes) to the volumes.
        stack = stack.contiguous()
        lstack = lstack.contiguous() if lstack is not None else None
    elif stack.device.type != "cpu":
        raise ValueError(f"sweep_base: no sweep for device {stack.device}")
    return _SweepFwd.apply(stack, lstack, *args, cfg.emission, flip,
                           cfg.address_mode, low)
