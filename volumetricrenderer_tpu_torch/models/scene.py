"""Procedural density volumes and multi-volume scenes (port of
volumetricrenderer_tpu/models/scene.py): noise -> min-max normalize ->
invert -> sharpen per channel, the FBM cloud that the flagship render
sweeps, the smoke column, and BASELINE config 3's two-volume scene baked
onto one grid (the target of the config-3 fit), or summed in place
(two_volume_grid)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import VolumeConfig
from ..ops import noise as noise_ops

__all__ = ["build_channel", "build_volume", "cloud_volume", "smoke_volume",
           "Volume", "translate_w2l", "bake_scene", "config3_scene",
           "two_volume_grid"]


def build_channel(kind, size, frequency, seed, octaves=1, sharpen_power=1,
                  device=None):
    """One normalized (size, size, size) channel in [0, 1]."""
    raw = noise_ops.noise_grid(kind, size, frequency, seed, octaves=octaves,
                               device=device)
    lo = torch.min(raw)
    hi = torch.max(raw)
    n = 1.0 - (raw - lo) / torch.clamp(hi - lo, min=1e-12)
    if sharpen_power > 1:
        n = n ** sharpen_power
    return n


def build_volume(cfg: VolumeConfig, device="cuda"):
    """The full (size, size, size, C) float32 grid in [0, 1]; with
    quantize_uint8 the values snap to the 256-level unorm lattice. Built on
    `device`, "cuda" unless the caller asks for another: without a GPU the
    default raises torch's own error."""
    channels = [
        build_channel(ch.kind, cfg.size, ch.frequency, ch.seed,
                      octaves=ch.octaves, sharpen_power=ch.sharpen_power,
                      device=device)
        for ch in cfg.channels
    ]
    grid = torch.stack(channels, dim=-1)
    if cfg.quantize_uint8:
        grid = torch.floor(grid * 255.0) / 255.0
    return grid


def cloud_volume(size, seed=7, octaves=5, coverage=0.45, device="cuda"):
    """A puffy FBM cloud, (size, size, size) float32: fbm noise thresholded
    softly by a radial falloff, normalized to a maximum of 1. Built on
    `device`, "cuda" unless the caller asks for another: without a GPU the
    default raises torch's own error."""
    n = build_channel("fbm", size, 4.0 / size, seed, octaves=octaves,
                      device=device)
    idx = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size - 0.5
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    r = torch.sqrt(xx * xx + yy * yy + zz * zz) * 2.0
    falloff = torch.clamp(1.0 - r, 0.0, 1.0)
    d = torch.clamp(n - (1.0 - coverage), 0.0, 1.0) * falloff
    return d / torch.clamp(torch.max(d), min=1e-6)


def smoke_volume(size, seed=23, octaves=4, device="cuda"):
    """A wispy smoke column, (size, size, size) float32: FBM modulated by a
    vertical gradient and a horizontal Gaussian core, normalized to a
    maximum of 1. Built on `device`, "cuda" unless the caller asks for
    another: without a GPU the default raises torch's own error."""
    n = build_channel("fbm", size, 6.0 / size, seed, octaves=octaves,
                      device=device)
    idx = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    core = torch.exp(-(((xx - 0.5) ** 2 + (yy - 0.5) ** 2) / 0.02))
    d = n * core * zz
    return d / torch.clamp(torch.max(d), min=1e-6)


@dataclasses.dataclass(frozen=True)
class Volume:
    """A density grid with an optional (4, 4) world_to_local transform
    (None: the identity)."""

    grid: torch.Tensor  # (D, H, W) or (D, H, W, C)
    world_to_local: Optional[torch.Tensor] = None


def translate_w2l(tx, ty, tz, device="cuda"):
    """world_to_local of a volume translated by (tx, ty, tz): local =
    world - t. On `device`, "cuda" unless the caller asks for another, as
    the volumes it goes with."""
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[:3, 3] = torch.tensor([-tx, -ty, -tz], dtype=torch.float32,
                            device=device)
    return m


def bake_scene(volumes, size, cfg):
    """Resample a multi-volume scene onto one shared (size^3) grid over the
    config box, on the volumes' device. Densities of overlapping volumes
    add; positions outside a volume's own box contribute zero."""
    from ..ops.sampling import sample_trilinear

    dev = volumes[0].grid.device
    box_min = torch.tensor(cfg.box_min, dtype=torch.float32, device=dev)
    box_range = torch.tensor(cfg.box_max, dtype=torch.float32,
                             device=dev) - box_min
    idx = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    pos01 = torch.stack([xx, yy, zz], dim=-1)  # (D, H, W, 3), (x, y, z)
    world = pos01 * box_range + box_min
    total = torch.zeros((size, size, size), dtype=torch.float32, device=dev)
    for vol in volumes:
        if vol.world_to_local is None:
            p = pos01
        else:
            m = vol.world_to_local.to(device=dev, dtype=torch.float32)
            local = world @ m[:3, :3].T + m[:3, 3]
            p = (local - box_min) / box_range
        g = vol.grid[..., 0] if vol.grid.dim() == 4 else vol.grid
        inside = ((p >= 0.0) & (p <= 1.0)).all(dim=-1)
        total = total + torch.where(
            inside, sample_trilinear(g, p, cfg.address_mode),
            torch.zeros((), dtype=torch.float32, device=dev))
    return total


def config3_scene(size, cloud_seed=7, smoke_seed=23, device="cuda"):
    """BASELINE config 3: a cloud + smoke two-volume scene, two grids with
    per-volume world transforms (the cloud raised, the smoke column below
    it), translated by whole voxels of the [-1, 1] box. Built on `device`,
    "cuda" unless the caller asks for another: without a GPU the default
    raises torch's own error."""
    half = 2.0 / size  # one voxel pitch of the [-1, 1] box
    cloud = Volume(cloud_volume(size, seed=cloud_seed, device=device),
                   translate_w2l(0.0, 0.0, round(0.5 / half) * half,
                                 device=device))
    smoke = Volume(smoke_volume(size, seed=smoke_seed, device=device),
                   translate_w2l(0.0, 0.0, -round(0.3 / half) * half,
                                 device=device))
    return [cloud, smoke]


def two_volume_grid(size, cloud_seed=7, smoke_seed=23, device="cuda"):
    """BASELINE config 3's cloud + smoke scene summed on one (size, size,
    size) grid in place, with no transforms: clip(cloud + 0.7 * smoke,
    0, 1). Built on `device`, "cuda" unless the caller asks for another:
    without a GPU the default raises torch's own error."""
    cloud = cloud_volume(size, seed=cloud_seed, device=device)
    smoke = smoke_volume(size, seed=smoke_seed, device=device)
    return torch.clamp(cloud + smoke * 0.7, 0.0, 1.0)
