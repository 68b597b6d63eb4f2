"""The reference configuration's input: the upstream renderer's 4-channel
noise volume, made from the run's seed.

Written from the port's definitions (volumetricrenderer_tpu_torch/ops/
noise.py simplex3 and cellular3, models/scene.py build_channel and
build_volume), as scene.py's FBM was; the lattice hash, its gradient and
Perlin noise are scene.py's own. Per channel, as the upstream does it
(TestMain.cpp:43-92): noise at voxel (x, y, z) sampled at (x, y, z) *
frequency, min-max normalized to [0, 1], inverted, and raised to the
channel's sharpen power. The benchmark makes the grid with this copy and
hands the same tensor to the program and to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.scene import _grad_dot, _hash3, _mul32, perlin3

_F3 = float(np.float32(1.0 / 3.0))
_G3 = float(np.float32(1.0 / 6.0))
_G3_2 = float(np.float32(2.0) * np.float32(1.0 / 6.0))
_G3_3 = float(np.float32(3.0) * np.float32(1.0 / 6.0))


def simplex3(coords, seed):
    """3-D simplex noise (Gustavson's construction)."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    s = (x + y + z) * _F3
    i, j, k = torch.floor(x + s), torch.floor(y + s), torch.floor(z + s)
    t = (i + j + k) * _G3
    x0, y0, z0 = x - (i - t), y - (j - t), z - (k - t)
    gx = (x0 >= y0).to(torch.int64) + (x0 >= z0).to(torch.int64)
    gy = (y0 > x0).to(torch.int64) + (y0 >= z0).to(torch.int64)
    gz = (z0 > x0).to(torch.int64) + (z0 > y0).to(torch.int64)
    i1, j1, k1 = ((g >= 2).to(torch.int64) for g in (gx, gy, gz))
    i2, j2, k2 = ((g >= 1).to(torch.int64) for g in (gx, gy, gz))
    ii, jj, kk = i.to(torch.int64), j.to(torch.int64), k.to(torch.int64)

    def corner(dx, dy, dz, oi, oj, ok):
        tt = torch.clamp(0.6 - dx * dx - dy * dy - dz * dz, min=0.0)
        g = _grad_dot(ii + oi, jj + oj, kk + ok, dx, dy, dz, seed)
        t2 = tt * tt
        return t2 * t2 * g

    n = (corner(x0, y0, z0, 0, 0, 0)
         + corner(x0 - i1 + _G3, y0 - j1 + _G3, z0 - k1 + _G3, i1, j1, k1)
         + corner(x0 - i2 + _G3_2, y0 - j2 + _G3_2, z0 - k2 + _G3_2,
                  i2, j2, k2)
         + corner(x0 - 1.0 + _G3_3, y0 - 1.0 + _G3_3, z0 - 1.0 + _G3_3,
                  1, 1, 1))
    return 32.0 * n


def _unit(h):
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def cellular3(coords, seed):
    """Worley noise: the distance to the nearest of one hashed feature
    point per unit cell, over the 27 cells around, times 1.6, minus 1."""
    cell = torch.floor(coords)
    base = cell.to(torch.int64)
    frac = coords - cell
    d2 = torch.full(coords.shape[:-1], float("inf"), dtype=torch.float32,
                    device=coords.device)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                h = _hash3(base[..., 0] + ox, base[..., 1] + oy,
                           base[..., 2] + oz, seed)
                dx = float(ox) + _unit(h) - frac[..., 0]
                dy = (float(oy) + _unit(_mul32(h, 0x68E31DA4) ^ (h >> 13))
                      - frac[..., 1])
                dz = (float(oz) + _unit(_mul32(h, 0xB5297A4D) ^ (h >> 7))
                      - frac[..., 2])
                d2 = torch.minimum(d2, dx * dx + dy * dy + dz * dz)
    return torch.sqrt(d2) * 1.6 - 1.0


NOISE = {"cellular": cellular3, "perlin": perlin3, "simplex": simplex3}


def channel(kind, size, frequency, seed, sharpen_power, device):
    """One (size,)*3 channel in [0, 1], indexed [z][y][x]."""
    idx = (torch.arange(size, dtype=torch.float32, device=device)
           * torch.tensor(frequency, dtype=torch.float32, device=device))
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    raw = NOISE[kind](torch.stack([xx, yy, zz], dim=-1), seed)
    lo, hi = torch.min(raw), torch.max(raw)
    n = 1.0 - (raw - lo) / torch.clamp(hi - lo, min=1e-12)
    return n ** sharpen_power if sharpen_power > 1 else n


def make_grid(volume: dict, seed: int, device) -> torch.Tensor:
    """The (size, size, size, 4) float32 grid of a configuration's
    "volume" entry of kind "noise_channels": channel c from its kind,
    frequency and sharpen power, with seed `seed` + c (the upstream's
    c + 1)."""
    if volume["kind"] != "noise_channels":
        raise ValueError(f"unknown volume kind {volume['kind']!r}")
    size = int(volume["size"])
    return torch.stack([
        channel(ch["kind"], size, ch["frequency"], seed + c,
                int(ch["sharpen_power"]), device)
        for c, ch in enumerate(volume["channels"])], dim=-1)
