"""Texel address modes (port of volumetricrenderer_tpu/ops/sampling.py's
apply_address_mode): mirror (Vulkan MIRRORED_REPEAT), clamp-to-edge and
wrap, applied to integer texel indices."""
from __future__ import annotations

import torch

__all__ = ["apply_address_mode"]


def apply_address_mode(idx: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """Map arbitrary integer texel indices into [0, size) per address mode.

    mirror: reflect with period 2*size; clamp: clamp to edge; wrap: modulo.
    torch.remainder, like jnp.remainder, is non-negative for a positive
    divisor."""
    if mode == "mirror":
        period = 2 * size
        m = torch.remainder(idx, period)
        return torch.where(m >= size, period - 1 - m, m)
    if mode == "clamp":
        return torch.clamp(idx, 0, size - 1)
    if mode == "wrap":
        return torch.remainder(idx, size)
    raise ValueError(f"unknown address mode {mode!r}")
