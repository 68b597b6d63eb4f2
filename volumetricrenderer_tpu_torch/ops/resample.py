"""Linear resampling as banded weight matrices (port of
volumetricrenderer_tpu/ops/resample.py's linear_resample_matrix), and the
gather-based bilinear sample of a 2-D image (sample_bilinear_2d).

`W @ line` linearly interpolates `line` at the given normalized positions
(texel i centered at (i+0.5)/n_in) under a sampler address mode. The sweep's
plain version (kernels/sweep_fwd.sweep_fwd_reference) builds its row and
column taps and its layer lerp from these matrices."""
from __future__ import annotations

import torch

from .sampling import apply_address_mode

__all__ = ["linear_taps", "linear_resample_matrix", "sample_bilinear_2d"]


def linear_taps(u01: torch.Tensor, n_in: int, address_mode: str = "mirror",
                dtype: torch.dtype = torch.float32, round_bf16: bool = False):
    """The two taps of 1-D linear resampling at normalized positions:
    (i0, i1, w0, w1), texel indices (int64) and their weights 1 - f and f,
    each (n_out,). The sampler's modes fold into the indices; address_mode
    "zero" is vacuum outside the texel support: a tap beyond [0, n_in)
    weighs nothing (the light sweep's boundary, ops/lighting.py; not a
    sampler mode). round_bf16: the sweep's bfloat16 stream mode, each
    weight rounded to the nearest bfloat16 on its own (from the float32
    1 - f and f) and held in `dtype`."""
    p = u01.to(torch.float32) * n_in - 0.5
    i0f = torch.floor(p)
    f = (p - i0f).to(dtype)
    i0 = i0f.to(torch.int64)
    w0, w1 = 1.0 - f, f
    if round_bf16:
        w0, w1 = (w.to(torch.bfloat16).to(dtype) for w in (w0, w1))
    if address_mode == "zero":
        a0 = torch.clamp(i0, 0, n_in - 1)
        a1 = torch.clamp(i0 + 1, 0, n_in - 1)
        w0 = w0 * ((i0 >= 0) & (i0 < n_in)).to(dtype)
        w1 = w1 * ((i0 + 1 >= 0) & (i0 + 1 < n_in)).to(dtype)
    else:
        a0 = apply_address_mode(i0, n_in, address_mode)
        a1 = apply_address_mode(i0 + 1, n_in, address_mode)
    return a0, a1, w0, w1


def linear_resample_matrix(u01: torch.Tensor, n_in: int,
                           address_mode: str = "mirror",
                           dtype: torch.dtype = torch.float32,
                           zero_outside: bool = False,
                           round_bf16: bool = False) -> torch.Tensor:
    """(n_out, n_in) matrix with at most two non-zeros per row, the taps
    of linear_taps (address modes and round_bf16 as there); zero_outside=
    True zeroes rows whose position leaves [0, 1]. Where an address mode
    puts both taps of a row on one texel, the entry is the sum of the two
    (rounded) weights, as the sweep kernels add both taps' products."""
    a0, a1, w0, w1 = linear_taps(u01, n_in, address_mode, dtype, round_bf16)
    cols = torch.arange(n_in, device=u01.device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=u01.device)
    w0 = torch.where(cols == a0[:, None], w0[:, None], zero)
    w1 = torch.where(cols == a1[:, None], w1[:, None], zero)
    W = (w0 + w1).to(dtype)
    if zero_outside:
        inr = ((u01 >= 0.0) & (u01 <= 1.0)).to(dtype)
        W = W * inr[:, None]
    return W


def sample_bilinear_2d(img, rows01, cols01, address_mode="clamp"):
    """Bilinear sample of an (H, W) or (H, W, C) image at normalized
    positions rows01, cols01 (same shape, texel-center convention as
    sample_trilinear) by four gathers. Differentiable in img."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W, _ = img.shape
    py = rows01.to(torch.float32) * H - 0.5
    px = cols01.to(torch.float32) * W - 0.5
    y0f, x0f = torch.floor(py), torch.floor(px)
    fy, fx = (py - y0f)[..., None], (px - x0f)[..., None]
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    y0w = apply_address_mode(y0, H, address_mode)
    y1w = apply_address_mode(y0 + 1, H, address_mode)
    x0w = apply_address_mode(x0, W, address_mode)
    x1w = apply_address_mode(x0 + 1, W, address_mode)
    c00, c01 = img[y0w, x0w], img[y0w, x1w]
    c10, c11 = img[y1w, x0w], img[y1w, x1w]
    c0 = c00 + fx * (c01 - c00)
    c1 = c10 + fx * (c11 - c10)
    out = c0 + fy * (c1 - c0)
    return out[..., 0] if squeeze else out
