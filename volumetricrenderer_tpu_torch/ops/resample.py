"""Linear resampling as banded weight matrices (port of
volumetricrenderer_tpu/ops/resample.py's linear_resample_matrix).

`W @ line` linearly interpolates `line` at the given normalized positions
(texel i centered at (i+0.5)/n_in) under a sampler address mode. The sweep's
plain version (kernels/sweep_fwd.sweep_fwd_reference) builds its row and
column taps and its layer lerp from these matrices."""
from __future__ import annotations

import torch

from .sampling import apply_address_mode

__all__ = ["linear_resample_matrix"]


def linear_resample_matrix(u01: torch.Tensor, n_in: int,
                           address_mode: str = "mirror",
                           dtype: torch.dtype = torch.float32,
                           zero_outside: bool = False) -> torch.Tensor:
    """(n_out, n_in) matrix with at most two non-zeros per row;
    zero_outside=True zeroes rows whose position leaves [0, 1]. (The JAX
    version's "zero" address mode serves only the light sweep, which is not
    ported yet.)"""
    p = u01.to(torch.float32) * n_in - 0.5
    i0f = torch.floor(p)
    f = (p - i0f).to(dtype)
    i0 = i0f.to(torch.int64)
    a0 = apply_address_mode(i0, n_in, address_mode)
    a1 = apply_address_mode(i0 + 1, n_in, address_mode)
    cols = torch.arange(n_in, device=u01.device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=u01.device)
    w0 = torch.where(cols == a0[:, None], (1.0 - f)[:, None], zero)
    w1 = torch.where(cols == a1[:, None], f[:, None], zero)
    W = (w0 + w1).to(dtype)
    if zero_outside:
        inr = ((u01 >= 0.0) & (u01 <= 1.0)).to(dtype)
        W = W * inr[:, None]
    return W
