"""Procedural density volumes (port of build_channel, build_volume and
cloud_volume from volumetricrenderer_tpu/models/scene.py): noise -> min-max
normalize -> invert -> sharpen per channel, and the FBM cloud that the
flagship render sweeps."""
from __future__ import annotations

import torch

from ..config import VolumeConfig
from ..ops import noise as noise_ops

__all__ = ["build_channel", "build_volume", "cloud_volume"]


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


def build_volume(cfg: VolumeConfig, device=None):
    """The full (size, size, size, C) float32 grid in [0, 1]; with
    quantize_uint8 the values snap to the 256-level unorm lattice."""
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


def cloud_volume(size, seed=7, octaves=5, coverage=0.45, device=None):
    """A puffy FBM cloud, (size, size, size) float32: fbm noise thresholded
    softly by a radial falloff, normalized to a maximum of 1."""
    n = build_channel("fbm", size, 4.0 / size, seed, octaves=octaves,
                      device=device)
    idx = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size - 0.5
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    r = torch.sqrt(xx * xx + yy * yy + zz * zz) * 2.0
    falloff = torch.clamp(1.0 - r, 0.0, 1.0)
    d = torch.clamp(n - (1.0 - coverage), 0.0, 1.0) * falloff
    return d / torch.clamp(torch.max(d), min=1e-6)
