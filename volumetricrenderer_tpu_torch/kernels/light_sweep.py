"""The light sweep's scan (ops/lighting.py): the wrapper of its hand-written
CUDA kernel (csrc/light_sweep.cu), the kernel's plain PyTorch version
(light_sweep_reference) and the plain version of its adjoint
(light_sweep_adjoint_reference).

The scan builds the light-transmittance volume from sigma permuted so the
sweep axis is dim 0, (S, A, B): from the light side inward,

    tau_0 = 0,  tau_j = ShearB(ShearA(tau_{j-1} + sigma_{j-1} * dl)),
    L_j = exp(-density * tau_j)

in slice order (highest slice first when the light lies toward +k). Each
shear resamples by the light's constant inter-slice offset with zero weight
outside the box: a table of two taps per output line (shear_taps), the
non-zeros of the dense matrix that linear_resample_matrix(..., "zero",
zero_outside=True) builds, weight for weight. The geometry (sign, the two
float32 shifts, dl, density) is a `LightSweep`, worked out on the host by
ops/lighting.py.

`light_sweep` runs the scan: on a CUDA tensor as one autograd node whose
forward launches the kernel and whose backward launches it again as the
adjoint scan (reverse slice order, transposed tables), or raises; on a CPU
tensor it is the plain version, which autograd differentiates. There is no
fallback from one device's path to the other's. The plain version takes
the same two taps in the same rounding order (each multiply and add
rounded on its own, tap 0 first), so on the card the kernel's forward
equals it bit for bit; on any device it equals the dense-matmul loop bit
for bit where every weight is 0.5 (config 4's light), and to float32
rounding elsewhere.

`launches` counts the kernel launches made by this module, forward and
adjoint apart.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..ops.resample import linear_taps
from .build import build_library

__all__ = ["LightSweep", "Taps", "shear_taps", "light_sweep",
           "light_sweep_reference", "light_sweep_adjoint_reference",
           "build_kernel", "launch_kernel", "launches"]

# kernel launches since import (or since a caller reset them)
launches = {"forward": 0, "adjoint": 0}

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output

MAX_TAPS = 4  # csrc/light_sweep.cu kMaxTaps: taps of a table row
MAX_B = 227 * 1024 // 4  # a row of B floats fits the kernel's stage
_NEEDS_CARRY = -1  # csrc/light_sweep.cu kNeedsCarry


class LightSweep(NamedTuple):
    """The host's geometry of one sweep: sign (+1: the light lies toward +k,
    the highest slice is lit first), the A and B shifts in normalized
    coordinates rounded to float32 (the shear's offset per slice step),
    the world-space path length dl of a step and the medium's density."""
    sign: int
    shift_a: float
    shift_b: float
    dl: float
    density: float


class Taps(NamedTuple):
    """A shear as a tap table: output line i is sum_t w[i, t] * in[idx[i,
    t]]; reach is the largest |idx[i, t] - i|, how far the kernel reads."""
    idx: torch.Tensor  # (n, T) int32
    w: torch.Tensor    # (n, T) float32
    reach: int


@functools.lru_cache(maxsize=64)
def shear_taps(n: int, shift: float, device, transposed: bool = False):
    """The shear of one axis of n texels by `shift` as Taps, computed once
    per (n, shift, device, transposed) (one read to the host). Row i of the
    forward table (T = 2) holds the taps of linear_taps at (i + 0.5) / n +
    shift with address mode "zero", both weights zeroed where the position
    leaves [0, 1]: the non-zeros of linear_resample_matrix(..., "zero",
    zero_outside=True)'s row i, and zero weights at the clamped indices
    beside them. The transposed table holds the non-zeros of the matrix's
    column i, rows in ascending order, padded to the fullest column's T with
    zero weights at index i."""
    device = torch.device(device)
    x01 = (torch.arange(n, dtype=torch.float32, device=device)
           + 0.5) / n + shift
    a0, a1, w0, w1 = linear_taps(x01, n, "zero")
    inr = ((x01 >= 0.0) & (x01 <= 1.0)).to(torch.float32)
    idx = torch.stack([a0, a1], 1).to(torch.int32)
    w = torch.stack([w0 * inr, w1 * inr], 1)
    idx_np = idx.cpu().numpy()
    if transposed:
        rows = np.repeat(np.arange(n), 2)
        cols, ws = idx_np.ravel(), w.cpu().numpy().ravel()
        keep = ws != 0.0
        rows, cols, ws = rows[keep], cols[keep], ws[keep]
        order = np.lexsort((rows, cols))  # by column, then row
        rows, cols, ws = rows[order], cols[order], ws[order]
        count = np.bincount(cols, minlength=n)
        T = max(1, int(count.max(initial=0)))
        slot = np.arange(cols.size) \
            - np.repeat(np.cumsum(count) - count, count)
        idx_np = np.repeat(np.arange(n, dtype=np.int32)[:, None], T, 1)
        tw = np.zeros((n, T), np.float32)
        idx_np[cols, slot], tw[cols, slot] = rows, ws
        idx = torch.from_numpy(idx_np).to(device)
        w = torch.from_numpy(tw).to(device)
    reach = int(np.abs(idx_np - np.arange(n)[:, None]).max(initial=0))
    return Taps(idx, w, reach)


def _tables(shape, sweep: LightSweep, device, transposed=False):
    _, A, B = shape
    return (shear_taps(A, sweep.shift_a, device, transposed),
            shear_taps(B, sweep.shift_b, device, transposed))


def _order(S, sign):
    """(first, step): slice order of the forward scan, lit side first."""
    return (S - 1, -1) if sign > 0 else (0, 1)


def _shear(y, table, dim):
    """The shear of y (A, B) along dim by a tap table: sum_t w[:, t] *
    y gathered at idx[:, t], tap 0 first, each product and sum rounded
    on its own."""
    idx, w, _ = table
    w = w.to(y.dtype)
    out = None
    for t in range(idx.shape[1]):
        wt = w[:, t, None] if dim == 0 else w[None, :, t]
        term = wt * y.index_select(dim, idx[:, t].long())
        out = term if out is None else out + term
    return out


def light_sweep_reference(sigma, sweep: LightSweep):
    """The kernel's plain version: L (S, A, B) of sigma (S, A, B), in
    sigma's dtype and on its device, differentiable by autograd. The
    slices are unbound once (their gradients stack once in the backward)
    and L is exp of the stacked carries."""
    S, A, B = sigma.shape
    rows, cols = _tables(sigma.shape, sweep, sigma.device)
    first, step = _order(S, sweep.sign)
    order = [first + i * step for i in range(S)]
    slices = sigma.unbind(0)
    tau = torch.zeros((A, B), dtype=sigma.dtype, device=sigma.device)
    taus = [None] * S
    taus[order[0]] = tau
    for k_prev, k in zip(order, order[1:]):
        y = tau + slices[k_prev] * sweep.dl
        tau = _shear(_shear(y, rows, 0), cols, 1)
        taus[k] = tau
    return torch.exp(-sweep.density * torch.stack(taus))


def light_sweep_adjoint_reference(L, dL, sweep: LightSweep):
    """The adjoint kernel's plain version: the gradient of sigma from L
    (the forward's result) and its cotangent dL, by the reverse scan the
    kernel runs: u <- ShearT(u + g_k), g_k = (-density * L_k) * dL_k,
    dsigma of the slice before k in sweep order = dl * u; the last slice
    in sweep order gets 0."""
    S, A, B = L.shape
    rows, cols = _tables(L.shape, sweep, L.device, transposed=True)
    first, step = _order(S, sweep.sign)
    order = [first + i * step for i in range(S)][::-1]
    out = torch.empty_like(L)
    u = torch.zeros((A, B), dtype=L.dtype, device=L.device)
    out[order[0]] = sweep.dl * u
    for k_prev, k in zip(order, order[1:]):
        y = u + (-sweep.density * L[k_prev]) * dL[k_prev]
        u = _shear(_shear(y, rows, 0), cols, 1)
        out[k] = sweep.dl * u
    return out


def build_kernel():
    """Build (at first use) and load the kernel's library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("light_sweep")
        fn = lib.light_sweep_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2 \
            + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(src, sweep: LightSweep, aux=None):
    """Check the inputs, allocate the output, launch one scan on the current
    stream and count it; the carry's scratch is allocated only where the
    library asks for it (the schedule with the carry in global memory).
    The forward (aux None): src is sigma (S, A, B), returns L. The adjoint:
    src is L and aux its cotangent dL, returns the gradient of sigma.
    Contiguous float32 CUDA tensors of one shape."""
    adjoint = aux is not None
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"light_sweep kernel: needs CUDA tensors, got {dev}")
    for name, t in (("src", src), ("aux", aux)):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 3 \
                or t.shape != src.shape:
            raise ValueError(
                f"light_sweep kernel: {name} must be a contiguous float32 "
                f"(S, A, B) tensor on {dev} of src's shape; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
    S, A, B = src.shape
    if min(S, A, B) < 1 or B > MAX_B:
        raise ValueError(f"light_sweep kernel: (S, A, B) = {(S, A, B)}: "
                         f"each at least 1, B at most {MAX_B}")
    rows, cols = _tables(src.shape, sweep, dev, adjoint)
    if max(rows.idx.shape[1], cols.idx.shape[1]) > MAX_TAPS:
        raise ValueError("light_sweep kernel: a shear column has more than "
                         f"{MAX_TAPS} taps")
    first, step = _order(S, sweep.sign)
    dl = float(np.float32(sweep.dl))
    nd = float(np.float32(-sweep.density))
    scale_in, scale_out = dl, nd
    if adjoint:
        first, step = first + (S - 1) * step, -step
        scale_in, scale_out = nd, dl
    build_kernel()
    out = torch.empty_like(src)

    def launch(carry):
        return _lib.light_sweep_launch(
            src.data_ptr(), aux.data_ptr() if adjoint else None,
            out.data_ptr(), carry, S, A, B, first, step,
            rows.idx.data_ptr(), rows.w.data_ptr(), rows.idx.shape[1],
            cols.idx.data_ptr(), cols.w.data_ptr(), cols.idx.shape[1],
            rows.reach, scale_in, scale_out, int(adjoint),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        rc = launch(None)
        if rc == _NEEDS_CARRY:
            carry = torch.empty((2, A, B), dtype=torch.float32, device=dev)
            rc = launch(carry.data_ptr())
    if rc != 0:
        raise RuntimeError(f"light_sweep kernel launch failed: CUDA error "
                           f"{rc}")
    launches["adjoint" if adjoint else "forward"] += 1
    return out


class _LightSweep(torch.autograd.Function):
    """The scan on a CUDA tensor as one autograd node: the kernel forward,
    the kernel's adjoint backward. Saves only L."""

    @staticmethod
    def forward(ctx, sigma, sweep):
        L = launch_kernel(sigma.contiguous(), sweep)
        ctx.sweep = sweep
        ctx.save_for_backward(L)
        return L

    @staticmethod
    @once_differentiable
    def backward(ctx, dL):
        L, = ctx.saved_tensors
        return launch_kernel(L, ctx.sweep, aux=dL.contiguous()), None


def light_sweep(sigma, sweep: LightSweep):
    """L (S, A, B) of sigma (S, A, B), differentiable in sigma: the kernel
    (forward and adjoint) for a CUDA tensor, the plain version for a CPU
    tensor."""
    if sigma.device.type == "cpu":
        return light_sweep_reference(sigma, sweep)
    return _LightSweep.apply(sigma, sweep)
