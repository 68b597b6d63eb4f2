"""Texel address modes and trilinear grid sampling (port of
apply_address_mode and sample_trilinear from
volumetricrenderer_tpu/ops/sampling.py): mirror (Vulkan MIRRORED_REPEAT),
clamp-to-edge and wrap, applied to integer texel indices, and the
texel-center linear filter (texel i covers [i/N, (i+1)/N), so a normalized
position x samples at x*N - 0.5), and dequantize_uint8. Also clip_unit, the clip to [0, 1] with
jnp.clip's subgradient, which shades the light-transmittance sample."""
from __future__ import annotations

import torch

__all__ = ["apply_address_mode", "dequantize_uint8", "sample_trilinear",
           "clip_unit", "clip_unit_grad"]


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


def dequantize_uint8(grid_u8):
    """uint8 unorm -> float32 in [0, 1], x * (1 / 255) as the Vulkan sampler
    reads VK_FORMAT_R8G8B8A8_UNORM."""
    return grid_u8.to(torch.float32) * torch.tensor(1.0 / 255.0,
                                                    dtype=torch.float32)


def sample_trilinear(grid, coords, address_mode="mirror"):
    """Trilinearly sample a 3D grid at normalized coordinates.

    grid: (D, H, W) or (D, H, W, C) float, indexed [z][y][x];
    coords: (..., 3) with components (x, y, z), [0, 1] spanning the grid.
    Returns (...,) or (..., C). Differentiable in grid (the gathers'
    adjoint is a scatter-add)."""
    squeeze = grid.dim() == 3
    if squeeze:
        grid = grid[..., None]
    D, H, W, _ = grid.shape
    coords = torch.as_tensor(coords, device=grid.device)
    cdt = grid.dtype if grid.dtype.is_floating_point else torch.float32
    x = coords[..., 0].to(torch.float32) * W - 0.5
    y = coords[..., 1].to(torch.float32) * H - 0.5
    z = coords[..., 2].to(torch.float32) * D - 0.5

    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    fx = (x - x0f).to(cdt)[..., None]
    fy = (y - y0f).to(cdt)[..., None]
    fz = (z - z0f).to(cdt)[..., None]
    x0, y0, z0 = (t.to(torch.int64) for t in (x0f, y0f, z0f))

    x0w = apply_address_mode(x0, W, address_mode)
    x1w = apply_address_mode(x0 + 1, W, address_mode)
    y0w = apply_address_mode(y0, H, address_mode)
    y1w = apply_address_mode(y0 + 1, H, address_mode)
    z0w = apply_address_mode(z0, D, address_mode)
    z1w = apply_address_mode(z0 + 1, D, address_mode)

    c000 = grid[z0w, y0w, x0w]
    c100 = grid[z0w, y0w, x1w]
    c010 = grid[z0w, y1w, x0w]
    c110 = grid[z0w, y1w, x1w]
    c001 = grid[z1w, y0w, x0w]
    c101 = grid[z1w, y0w, x1w]
    c011 = grid[z1w, y1w, x0w]
    c111 = grid[z1w, y1w, x1w]

    c00 = c000 + fx * (c100 - c000)
    c10 = c010 + fx * (c110 - c010)
    c01 = c001 + fx * (c101 - c001)
    c11 = c011 + fx * (c111 - c011)
    c0 = c00 + fy * (c10 - c00)
    c1 = c01 + fy * (c11 - c01)
    out = c0 + fz * (c1 - c0)
    return out[..., 0] if squeeze else out


def clip_unit_grad(x):
    """d clip(x, 0, 1) / dx as jnp.clip defines it, minimum(maximum(x, 0),
    1): 1 inside (0, 1), 0.5 at x == 0 and x == 1 (the tie of a min or a
    max splits the gradient), 0 outside. torch.clamp passes the full
    gradient at both bounds."""
    inside = ((x > 0.0) & (x < 1.0)).to(x.dtype)
    tie = ((x == 0.0) | (x == 1.0)).to(x.dtype)
    return inside + 0.5 * tie


class _ClipUnit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def backward(ctx, ct):
        x, = ctx.saved_tensors
        return ct * clip_unit_grad(x)


def clip_unit(x):
    """clip(x, 0, 1) whose autograd gradient is clip_unit_grad: a light
    transmittance sample is exactly 1.0 in every fully lit voxel, so the
    value at the bound matters."""
    return _ClipUnit.apply(x)
