"""The benchmark's inputs: density grids made from the run's seed.

A frozen copy, taken at commit 38e9ffd, of the generators the port uses:
the lattice hash, Perlin noise and FBM (volumetricrenderer_tpu_torch/ops/
noise.py), the FBM cloud, the smoke column, the trilinear sample and the
bake of the config-3 scene (models/scene.py, ops/sampling.py). Only what
the configurations in configs/ build is kept. The benchmark makes every
grid with this copy and hands the same tensor to the program and to the
reference, so a change to the program's generators cannot change the
inputs.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PRIME_X = 0x9E3779B1
_PRIME_Y = 0x85EBCA77
_PRIME_Z = 0xC2B2AE3D
_PRIME_S = 0x27D4EB2F


def _mul32(a, c):
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash3(ix, iy, iz, seed):
    h = (_mul32(ix & _M32, _PRIME_X) ^ _mul32(iy & _M32, _PRIME_Y)
         ^ _mul32(iz & _M32, _PRIME_Z) ^ ((int(seed) & _M32) * _PRIME_S
                                          & _M32))
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _grad_dot(ix, iy, iz, dx, dy, dz, seed):
    b = _hash3(ix, iy, iz, seed) & 15
    u = torch.where(b < 8, dx, dy)
    v = torch.where(b < 4, dy, torch.where((b == 12) | (b == 14), dx, dz))
    return (torch.where((b & 1) == 0, u, -u)
            + torch.where((b & 2) == 0, v, -v))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(coords, seed):
    p0 = torch.floor(coords)
    ip = p0.to(torch.int64)
    f = coords - p0
    ix, iy, iz = ip[..., 0], ip[..., 1], ip[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def g(ox, oy, oz):
        return _grad_dot(ix + ox, iy + oy, iz + oz, fx - ox, fy - oy,
                         fz - oz, seed)

    nx00 = g(0, 0, 0) + u * (g(1, 0, 0) - g(0, 0, 0))
    nx10 = g(0, 1, 0) + u * (g(1, 1, 0) - g(0, 1, 0))
    nx01 = g(0, 0, 1) + u * (g(1, 0, 1) - g(0, 0, 1))
    nx11 = g(0, 1, 1) + u * (g(1, 1, 1) - g(0, 1, 1))
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return (nxy0 + w * (nxy1 - nxy0)) * 0.964921


def fbm3(coords, seed, octaves):
    total = torch.zeros(coords.shape[:-1], dtype=torch.float32,
                        device=coords.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * perlin3(coords * freq, seed + o * 1013)
        norm, amp, freq = norm + amp, amp * 0.5, freq * 2.0
    return total / norm


def fbm_channel(size, frequency, seed, octaves, device):
    """A (size,)*3 FBM channel, min-max normalized to [0, 1] and inverted;
    the sample at voxel (x, y, z) is fbm((x, y, z) * frequency)."""
    idx = (torch.arange(size, dtype=torch.float32, device=device)
           * torch.tensor(frequency, dtype=torch.float32, device=device))
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    raw = fbm3(torch.stack([xx, yy, zz], dim=-1), seed, octaves)
    lo, hi = torch.min(raw), torch.max(raw)
    return 1.0 - (raw - lo) / torch.clamp(hi - lo, min=1e-12)


def _centers(size, device, offset):
    idx = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
        / size - offset
    return torch.meshgrid(idx, idx, idx, indexing="ij")


def cloud_volume(size, seed, device, octaves=5, coverage=0.45):
    """The FBM cloud: fbm at frequency 4/size thresholded softly by a
    radial falloff, normalized to a maximum of 1."""
    n = fbm_channel(size, 4.0 / size, seed, octaves, device)
    zz, yy, xx = _centers(size, device, 0.5)
    r = torch.sqrt(xx * xx + yy * yy + zz * zz) * 2.0
    d = torch.clamp(n - (1.0 - coverage), 0.0, 1.0) \
        * torch.clamp(1.0 - r, 0.0, 1.0)
    return d / torch.clamp(torch.max(d), min=1e-6)


def smoke_volume(size, seed, device, octaves=4):
    """The smoke column: fbm at frequency 6/size times a vertical gradient
    and a horizontal Gaussian core, normalized to a maximum of 1."""
    n = fbm_channel(size, 6.0 / size, seed, octaves, device)
    zz, yy, xx = _centers(size, device, 0.0)
    core = torch.exp(-(((xx - 0.5) ** 2 + (yy - 0.5) ** 2) / 0.02))
    d = n * core * zz
    return d / torch.clamp(torch.max(d), min=1e-6)


def _mirror(idx, size):
    m = torch.remainder(idx, 2 * size)
    return torch.where(m >= size, 2 * size - 1 - m, m)


def sample_trilinear(grid, p):
    """Trilinear sample of a (D, H, W) grid at normalized (x, y, z)
    positions p (..., 3), mirror addressing, texel centers at (i+0.5)/n."""
    D, H, W = grid.shape
    x, y, z = p[..., 0] * W - 0.5, p[..., 1] * H - 0.5, p[..., 2] * D - 0.5
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0f, y - y0f, z - z0f
    x0, y0, z0 = (t.to(torch.int64) for t in (x0f, y0f, z0f))
    xs = (_mirror(x0, W), _mirror(x0 + 1, W))
    ys = (_mirror(y0, H), _mirror(y0 + 1, H))
    zs = (_mirror(z0, D), _mirror(z0 + 1, D))

    def at(i, j, k):
        return grid[zs[k], ys[j], xs[i]]

    c00 = at(0, 0, 0) + fx * (at(1, 0, 0) - at(0, 0, 0))
    c10 = at(0, 1, 0) + fx * (at(1, 1, 0) - at(0, 1, 0))
    c01 = at(0, 0, 1) + fx * (at(1, 0, 1) - at(0, 0, 1))
    c11 = at(0, 1, 1) + fx * (at(1, 1, 1) - at(0, 1, 1))
    c0 = c00 + fy * (c10 - c00)
    c1 = c01 + fy * (c11 - c01)
    return c0 + fz * (c1 - c0)


def bake_translated(volumes, size, device):
    """(grid, (tx, ty, tz)) volumes of the [-1, 1] box, each translated by
    its offset, resampled onto one size^3 grid; overlapping densities add
    and a position outside a volume's own box takes nothing from it."""
    idx = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
        / size
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    pos01 = torch.stack([xx, yy, zz], dim=-1)
    world = pos01 * 2.0 - 1.0
    total = torch.zeros((size,) * 3, dtype=torch.float32, device=device)
    for grid, offset in volumes:
        m = torch.eye(4, dtype=torch.float32, device=device)
        m[:3, 3] = -torch.tensor(offset, dtype=torch.float32, device=device)
        p = ((world @ m[:3, :3].T + m[:3, 3]) + 1.0) / 2.0
        inside = ((p >= 0.0) & (p <= 1.0)).all(dim=-1)
        total = total + torch.where(inside, sample_trilinear(grid, p),
                                    torch.zeros((), device=device))
    return total


def make_grid(volume: dict, seed: int, device) -> torch.Tensor:
    """The (D, H, W) float32 density grid a configuration's "volume" entry
    describes, from the run's seed: "cloud" is the FBM cloud with the seed
    in place of the preset's 7; "config3_scene" is the cloud raised by
    round(0.5 / pitch) voxels and the smoke column (seed + smoke_seed_offset
    in place of 23) lowered by round(0.3 / pitch), baked onto one grid."""
    size, kind = int(volume["size"]), volume["kind"]
    if kind == "cloud":
        return cloud_volume(size, seed, device)
    if kind == "config3_scene":
        pitch = 2.0 / size
        cloud = cloud_volume(size, seed, device)
        smoke = smoke_volume(size, seed + int(volume["smoke_seed_offset"]),
                             device)
        return bake_translated(
            [(cloud, (0.0, 0.0, round(0.5 / pitch) * pitch)),
             (smoke, (0.0, 0.0, -round(0.3 / pitch) * pitch))], size, device)
    raise ValueError(f"unknown volume kind {kind!r}")
