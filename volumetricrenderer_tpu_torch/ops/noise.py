"""Procedural 3D noise (port of volumetricrenderer_tpu/ops/noise.py):
the lattice hash, Perlin noise, FBM and uniform noise grids, enough for the
FBM cloud. Simplex and cellular noise are not ported yet.

Torch has no general uint32 arithmetic, so the hash runs on int64 tensors
holding uint32 values: every product is reduced mod 2**32, and products are
split into 16-bit halves so no intermediate leaves int64's range. Hashes are
bit-equal to the JAX ones (a test pins that).
"""
from __future__ import annotations

import torch

__all__ = ["perlin3", "fbm3", "noise_grid"]

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


def noise_grid(kind, size, frequency, seed, octaves=1, device=None):
    """A size^3 float32 grid indexed [z][y][x]: the sample at voxel
    (x, y, z) is noise((x, y, z) * frequency, seed)."""
    idx = (torch.arange(size, dtype=torch.float32, device=device)
           * torch.tensor(frequency, dtype=torch.float32, device=device))
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    coords = torch.stack([xx, yy, zz], dim=-1)
    if kind == "fbm":
        return fbm3(coords, seed, octaves=octaves)
    if kind == "perlin":
        return perlin3(coords, seed)
    raise NotImplementedError(
        f"noise kind {kind!r} is not ported yet (perlin and fbm are)")
