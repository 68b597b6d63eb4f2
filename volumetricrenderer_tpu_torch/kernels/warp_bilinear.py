"""The screen warp (ops/sweep.py _WarpBilinear) with its miss select: one
hand-written CUDA kernel each way (csrc/warp_bilinear.cu) on a CUDA base,
and its plain version (warp_reference, splat_reference) on a CPU base.

The warp resamples base-grid maps (Hb, Wb, C) to the camera pixels (H, W,
C) by the clip-then-tent bilinear taps of `taps`; with `miss`, a pixel
outside the base footprint (`in01` of its row or column fails) takes the
per-channel miss value. Its adjoint splats the pixel cotangents into the
base with the same four weights; with `miss`, an out-of-footprint pixel's
cotangent is zero and adds nothing. The kernel forward equals the plain
version on the card bit for bit; the adjoint sums a texel's adds with
atomics, in the order they land (as the plain version's index_add_ does
on the card), so its last bits vary from run to run.

The op (ops/sweep.py _WarpBilinear) takes the plain version on a CPU base
and the kernel on any other. The kernel takes a float32 base with 1 to 4
channels and float32 maps on the base's CUDA device, and refuses anything
else with a ValueError (check_inputs): a warp on the card never falls back
to the plain version's launches. Maps or cotangents that are not
contiguous are copied contiguous.

`launches` counts the kernel's launches, forward and backward apart.
splat_pixels() gives (the pixels the last kernel backward splatted, the
pixels it was given); it waits for that backward to finish.
"""
from __future__ import annotations

import ctypes

import torch

from .build import build_library

__all__ = ["in01", "taps", "warp_reference", "splat_reference",
           "check_inputs", "build_kernel", "launch_forward",
           "launch_backward", "launches", "splat_pixels", "MAX_CHANNELS"]

MAX_CHANNELS = 4  # csrc/warp_bilinear.cu kMaxChannels
BLOCK_PIXELS = 256  # csrc/warp_bilinear.cu kThreads: pixels a backward block

# kernel launches since import (or since a caller reset them)
launches = {"forward": 0, "backward": 0}

# the last kernel backward's per-block counts of splatted pixels, and the
# pixels it was given; read through splat_pixels()
_last_splat = (None, 0)

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output


def splat_pixels():
    """(pixels the last kernel backward splatted, pixels it was given);
    (0, 0) before the first. Waits for that backward to finish."""
    counts, given = _last_splat
    return (0 if counts is None else int(counts.sum()), given)


def in01(x):
    return (x >= 0.0) & (x <= 1.0)


def taps(q01, n):
    """Clip-then-tent bilinear taps along one base axis: the position
    clips to [0, n-1] texel units first, so an out-of-range position
    takes the edge texel with weight 1 (the JAX warp's _tap_weights)."""
    p = torch.clamp(q01 * n - 0.5, 0.0, float(n - 1))
    i0f = torch.floor(p)
    i0 = i0f.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n - 1), (p - i0f)[..., None]


def warp_reference(base, rows01, cols01, miss=None):
    """The plain version of the forward: the four gathers of the taps'
    texels, combined, then the miss select where `miss` (a tensor that
    broadcasts against the channels) is given."""
    Hb, Wb = base.shape[:2]
    r0, r1, fr = taps(rows01, Hb)
    c0, c1, fc = taps(cols01, Wb)
    out = ((1.0 - fc) * ((1.0 - fr) * base[r0, c0] + fr * base[r1, c0])
           + fc * ((1.0 - fr) * base[r0, c1] + fr * base[r1, c1]))
    if miss is None:
        return out
    return torch.where((in01(rows01) & in01(cols01))[..., None], out, miss)


def splat_reference(ct, rows01, cols01, base_shape, masked: bool):
    """The plain version of the backward: the base's gradient (Hb, Wb, C),
    the pixel cotangents ct (H, W, C) splatted with the four weights by
    index_add_ (atomics on CUDA); `masked` (miss was given) zeroes the
    out-of-footprint pixels' cotangents first."""
    Hb, Wb, C = base_shape
    if masked:
        ct = torch.where((in01(rows01) & in01(cols01))[..., None], ct,
                         ct.new_zeros(()))
    r0, r1, fr = taps(rows01, Hb)
    c0, c1, fc = taps(cols01, Wb)
    # The products in the order autograd of the forward forms them.
    left, right = ct * (1.0 - fc), ct * fc
    flat = ct.new_zeros(Hb * Wb, C)
    for r, c, w in ((r0, c0, left * (1.0 - fr)), (r1, c0, left * fr),
                    (r0, c1, right * (1.0 - fr)), (r1, c1, right * fr)):
        flat.index_add_(0, (r * Wb + c).reshape(-1), w.reshape(-1, C))
    return flat.view(Hb, Wb, C)


def check_inputs(base_shape, rows01, cols01, miss=None, ct=None):
    """Check a call before its pointers go to the kernel: base_shape (Hb,
    Wb, C) with 1 <= C <= 4; the two maps float32 of one shape; `miss`
    None or C floats; ct (the backward's cotangent) float32 of shape
    maps' + (C,) on the maps' device."""
    if len(base_shape) != 3 or min(base_shape) < 1 \
            or base_shape[2] > MAX_CHANNELS:
        raise ValueError(f"warp_bilinear: the base must be (Hb, Wb, C) "
                         f"with 1 <= C <= {MAX_CHANNELS}, got "
                         f"{tuple(base_shape)}")
    C = base_shape[2]
    for name, t in (("rows01", rows01), ("cols01", cols01)):
        if t.dtype != torch.float32 or t.device != rows01.device \
                or t.shape != rows01.shape:
            raise ValueError(
                f"warp_bilinear: {name} must be float32, of rows01's shape "
                f"{tuple(rows01.shape)} on {rows01.device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if miss is not None and len(miss) != C:
        raise ValueError(f"warp_bilinear: miss must hold {C} values, got "
                         f"{len(miss)}")
    if ct is not None and (ct.dtype != torch.float32
                           or ct.device != rows01.device
                           or ct.shape != rows01.shape + (C,)):
        raise ValueError(
            f"warp_bilinear: ct must be float32 of shape "
            f"{tuple(rows01.shape) + (C,)} on {rows01.device}; got "
            f"{ct.dtype} {tuple(ct.shape)} on {ct.device}")


def build_kernel():
    """Build (at first use) and load the kernels' library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("warp_bilinear")
        lib.warp_bilinear_fwd_launch.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
            + [ctypes.c_float] * 4 + [ctypes.c_void_p]
        lib.warp_bilinear_bwd_launch.argtypes = \
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        for fn in (lib.warp_bilinear_fwd_launch, lib.warp_bilinear_bwd_launch):
            fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def _needs_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"warp_bilinear kernel: needs CUDA tensors, got "
                         f"{t.device}")


def _raise_on(rc, way):
    if rc != 0:
        raise RuntimeError(f"warp_bilinear {way} kernel launch failed: CUDA "
                           f"error {rc}")


def launch_forward(base, rows01, cols01, miss=None):
    """The warp of `base` (Hb, Wb, C) at the maps (H, W) as one launch on
    the current stream, counted: the (H, W, C) float32 output. `miss`: None
    or C floats for the out-of-footprint pixels."""
    check_inputs(tuple(base.shape), rows01, cols01, miss)
    if base.dtype != torch.float32 or base.device != rows01.device:
        raise ValueError(f"warp_bilinear: base must be float32 on "
                         f"{rows01.device}, got {base.dtype} on "
                         f"{base.device}")
    _needs_cuda(rows01)
    Hb, Wb, C = base.shape
    build_kernel()
    base, rows01, cols01 = (t.contiguous() for t in (base, rows01, cols01))
    out = torch.empty(rows01.shape + (C,), dtype=torch.float32,
                      device=base.device)
    vals = list(miss or ())
    vals += [0.0] * (MAX_CHANNELS - len(vals))
    dev = base.device
    with torch.cuda.device(dev):
        rc = _lib.warp_bilinear_fwd_launch(
            base.data_ptr(), rows01.data_ptr(), cols01.data_ptr(),
            out.data_ptr(), rows01.numel(), Hb, Wb, C, int(miss is not None),
            *vals, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "forward")
    launches["forward"] += 1
    return out


def launch_backward(ct, rows01, cols01, base_shape, masked: bool):
    """The splat of ct (H, W, C) into a new (Hb, Wb, C) gradient as one
    launch on the current stream (after a memset), counted; `masked`: the
    in-footprint pixels only. The count of splatted pixels is left for
    splat_pixels()."""
    global _last_splat
    check_inputs(tuple(base_shape), rows01, cols01, ct=ct)
    _needs_cuda(rows01)
    Hb, Wb, C = base_shape
    build_kernel()
    ct, rows01, cols01 = (t.contiguous() for t in (ct, rows01, cols01))
    dev = ct.device
    grad = torch.empty((Hb, Wb, C), dtype=torch.float32, device=dev)
    n = rows01.numel()
    blocks = -(-n // BLOCK_PIXELS)
    counts = torch.empty(max(1, blocks), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.warp_bilinear_bwd_launch(
            ct.data_ptr(), rows01.data_ptr(), cols01.data_ptr(),
            grad.data_ptr(), counts.data_ptr(), n, Hb, Wb, C, int(masked),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "backward")
    launches["backward"] += 1
    _last_splat = (counts[:blocks], n)
    return grad
