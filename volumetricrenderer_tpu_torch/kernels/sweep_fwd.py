"""Forward slice sweep: the wrapper in place of
volumetricrenderer_tpu/kernels/sweep_pallas.py's sweep_base_pallas, its
hand-written CUDA kernel (csrc/sweep_fwd.cu) and the kernel's plain PyTorch
version (sweep_fwd_reference).

`sweep_base` dispatches on the device of the grid it is given: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version. There is no fallback from one to the other. The kernel's
autograd.Function has no backward yet: the backward kernel is a port of
sweep_pallas.py's `_bwd_kernel`, still to come, and backward() through the
kernel raises rather than run the plain version. The plain version is
differentiable by ordinary autograd.

`launches` counts the kernel launches made by this module.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import LightConfig, MediumConfig, RenderConfig
from ..ops.resample import linear_resample_matrix
from ..ops.sampling import apply_address_mode
from .build import build_library

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
    if dev.type != "cuda":
        raise ValueError(f"sweep_fwd kernel: needs CUDA tensors, got {dev}")
    named = dict(stack=stack, slice_z=slice_z, v_grid=v_grid, u_grid=u_grid,
                 seglen=seglen, params=params)
    for name, t in named.items():
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"sweep_fwd kernel: {name} must be a contiguous float32 "
                f"tensor on {dev}; got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    if stack.dim() != 3:
        raise ValueError(f"sweep_fwd kernel: stack must be (S, A, B), "
                         f"got {tuple(stack.shape)}")
    S, A, B = stack.shape
    Hb, Wb = v_grid.numel(), u_grid.numel()
    want = dict(slice_z=(S,), v_grid=(Hb,), u_grid=(Wb,), seglen=(Hb, Wb),
                params=(8,))
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"sweep_fwd kernel: {name} must be {shape}, "
                             f"got {tuple(named[name].shape)}")
    if min(S, A, B, Hb, Wb) < 1:
        raise ValueError("sweep_fwd kernel: empty input")
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
    """The kernel as an autograd node: forward launches it, backward raises
    until the backward kernel is ported."""

    @staticmethod
    def forward(ctx, stack, slice_z, v_grid, u_grid, seglen, params,
                emission, flip, wrap):
        return tuple(launch_kernel(stack, slice_z, v_grid, u_grid, seglen,
                                   params, emission, flip, wrap).unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "backward through the CUDA sweep kernel is not ported yet (it is "
            "the port of volumetricrenderer_tpu/kernels/sweep_pallas.py "
            "_bwd_kernel); differentiate a CPU render, which runs the plain "
            "PyTorch sweep")


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
    grid permuted so the sweep axis is dim 0: the kernel for a CUDA grid,
    sweep_fwd_reference for a CPU grid."""
    (stack, *args), flip = sweep_inputs(gperm, plan, cfg, medium, light)
    if stack.device.type == "cuda":
        return _SweepFwd.apply(stack.contiguous(), *args, cfg.emission, flip,
                               cfg.address_mode == "wrap")
    if stack.device.type == "cpu":
        return sweep_fwd_reference(stack, *args, emission=cfg.emission,
                                   flip=flip, address_mode=cfg.address_mode)
    raise ValueError(f"sweep_base: no sweep for device {stack.device}")
