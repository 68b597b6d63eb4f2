"""Procedural 3D noise (port of volumetricrenderer_tpu/ops/noise.py):
the lattice hash, Perlin, simplex and cellular noise, FBM and uniform noise
grids: the generators of the FBM cloud and of the reference preset's
4-channel volume.

Torch has no general uint32 arithmetic, so the hash runs on int64 tensors
holding uint32 values: every product is reduced mod 2**32, and products are
split into 16-bit halves so no intermediate leaves int64's range. Hashes are
bit-equal to the JAX ones (a test pins that).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["perlin3", "simplex3", "cellular3", "fbm3", "noise_grid"]

_M32 = 0xFFFFFFFF

_PRIME_X = 0x9E3779B1
_PRIME_Y = 0x85EBCA77
_PRIME_Z = 0xC2B2AE3D
_PRIME_S = 0x27D4EB2F


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a in [0, 2**32) and a uint32 constant c,
    with every intermediate below 2**49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash3(ix, iy, iz, seed):
    """Avalanche hash of 3 integer lattice coords + seed -> uint32 values
    in an int64 tensor."""
    h = (_mul32(ix.to(torch.int64) & _M32, _PRIME_X)
         ^ _mul32(iy.to(torch.int64) & _M32, _PRIME_Y)
         ^ _mul32(iz.to(torch.int64) & _M32, _PRIME_Z)
         ^ ((int(seed) & _M32) * _PRIME_S & _M32))
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _hash_to_unit(h):
    """uint32 (in int64) -> float32 in [0, 1)."""
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def _grad_dot(ix, iy, iz, dx, dy, dz, seed):
    """Dot product of the hashed lattice gradient with offset (dx,dy,dz),
    selected arithmetically from the hash bits (Perlin's bit trick)."""
    b = _hash3(ix, iy, iz, seed) & 15
    u = torch.where(b < 8, dx, dy)
    v = torch.where(b < 4, dy, torch.where((b == 12) | (b == 14), dx, dz))
    su = torch.where((b & 1) == 0, u, -u)
    sv = torch.where((b & 2) == 0, v, -v)
    return su + sv


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(coords: torch.Tensor, seed) -> torch.Tensor:
    """Improved Perlin noise. coords: (..., 3) float32 -> (...)."""
    coords = coords.to(torch.float32)
    p0 = torch.floor(coords)
    ip = p0.to(torch.int64)
    f = coords - p0
    ix, iy, iz = ip[..., 0], ip[..., 1], ip[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def g(ox, oy, oz):
        return _grad_dot(ix + ox, iy + oy, iz + oz,
                         fx - ox, fy - oy, fz - oz, seed)

    n000, n100 = g(0, 0, 0), g(1, 0, 0)
    n010, n110 = g(0, 1, 0), g(1, 1, 0)
    n001, n101 = g(0, 0, 1), g(1, 0, 1)
    n011, n111 = g(0, 1, 1), g(1, 1, 1)

    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return (nxy0 + w * (nxy1 - nxy0)) * 0.964921  # ~unit range


# float32(1/3) and float32(1/6) and their float32 multiples, as the JAX
# version rounds them.
_F3 = float(np.float32(1.0 / 3.0))
_G3 = float(np.float32(1.0 / 6.0))
_G3_2 = float(np.float32(2.0) * np.float32(1.0 / 6.0))
_G3_3 = float(np.float32(3.0) * np.float32(1.0 / 6.0))


def simplex3(coords: torch.Tensor, seed) -> torch.Tensor:
    """3D simplex noise (Gustavson's construction). (..., 3) -> (...)."""
    coords = coords.to(torch.float32)
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    s = (x + y + z) * _F3
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    k = torch.floor(z + s)
    t = (i + j + k) * _G3
    x0 = x - (i - t)
    y0 = y - (j - t)
    z0 = z - (k - t)

    # Rank the components to find the simplex traversal order.
    gx = (x0 >= y0).to(torch.int64) + (x0 >= z0).to(torch.int64)
    gy = (y0 > x0).to(torch.int64) + (y0 >= z0).to(torch.int64)
    gz = (z0 > x0).to(torch.int64) + (z0 > y0).to(torch.int64)
    i1, j1, k1 = ((g >= 2).to(torch.int64) for g in (gx, gy, gz))
    i2, j2, k2 = ((g >= 1).to(torch.int64) for g in (gx, gy, gz))

    x1, y1, z1 = x0 - i1 + _G3, y0 - j1 + _G3, z0 - k1 + _G3
    x2, y2, z2 = x0 - i2 + _G3_2, y0 - j2 + _G3_2, z0 - k2 + _G3_2
    x3, y3, z3 = x0 - 1.0 + _G3_3, y0 - 1.0 + _G3_3, z0 - 1.0 + _G3_3

    ii, jj, kk = i.to(torch.int64), j.to(torch.int64), k.to(torch.int64)

    def corner(dx, dy, dz, oi, oj, ok):
        tt = torch.clamp(0.6 - dx * dx - dy * dy - dz * dz, min=0.0)
        g = _grad_dot(ii + oi, jj + oj, kk + ok, dx, dy, dz, seed)
        t2 = tt * tt
        return t2 * t2 * g

    n = (corner(x0, y0, z0, 0, 0, 0)
         + corner(x1, y1, z1, i1, j1, k1)
         + corner(x2, y2, z2, i2, j2, k2)
         + corner(x3, y3, z3, 1, 1, 1))
    return 32.0 * n


def cellular3(coords: torch.Tensor, seed) -> torch.Tensor:
    """Worley / cellular-distance noise: the distance to the nearest feature
    point, one feature point per unit cell, rescaled to roughly [-1, 1].
    (..., 3) -> (...)."""
    coords = coords.to(torch.float32)
    cell = torch.floor(coords)
    base = cell.to(torch.int64)
    frac = coords - cell

    min_d2 = torch.full(coords.shape[:-1], float("inf"), dtype=torch.float32,
                        device=coords.device)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                h = _hash3(base[..., 0] + ox, base[..., 1] + oy,
                           base[..., 2] + oz, seed)
                # Three decorrelated uniforms from one hash.
                fxp = _hash_to_unit(h)
                fyp = _hash_to_unit(_mul32(h, 0x68E31DA4) ^ (h >> 13))
                fzp = _hash_to_unit(_mul32(h, 0xB5297A4D) ^ (h >> 7))
                dx = float(ox) + fxp - frac[..., 0]
                dy = float(oy) + fyp - frac[..., 1]
                dz = float(oz) + fzp - frac[..., 2]
                min_d2 = torch.minimum(min_d2, dx * dx + dy * dy + dz * dz)
    return torch.sqrt(min_d2) * 1.6 - 1.0


def fbm3(coords: torch.Tensor, seed, octaves=5, lacunarity=2.0, gain=0.5):
    """Fractal Brownian motion over perlin3."""
    coords = coords.to(torch.float32)
    total = torch.zeros(coords.shape[:-1], dtype=torch.float32,
                        device=coords.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * perlin3(coords * freq, seed + o * 1013)
        norm = norm + amp
        amp = amp * gain
        freq = freq * lacunarity
    return total / norm


_GENERATORS = {
    "perlin": perlin3,
    "simplex": simplex3,
    "cellular": cellular3,
}


def noise_grid(kind, size, frequency, seed, octaves=1, device=None):
    """A size^3 float32 grid indexed [z][y][x]: the sample at voxel
    (x, y, z) is noise((x, y, z) * frequency, seed)."""
    idx = (torch.arange(size, dtype=torch.float32, device=device)
           * torch.tensor(frequency, dtype=torch.float32, device=device))
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    coords = torch.stack([xx, yy, zz], dim=-1)
    if kind == "fbm":
        return fbm3(coords, seed, octaves=octaves)
    if kind not in _GENERATORS:
        raise ValueError(f"unknown noise kind {kind!r}")
    return _GENERATORS[kind](coords, seed)
