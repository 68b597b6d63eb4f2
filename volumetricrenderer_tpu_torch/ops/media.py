"""Medium evaluation helpers (port of volumetricrenderer_tpu/ops/media.py):
the reference's 4-channel combine materialized as a dense extinction
volume.

The reference medium evaluates sigma per sample: four trilinear fetches at
per-channel scaled and scrolled coordinates, combined as
(s1*s2)*(s3+s4)*sample_scale. The light-propagation sweep (ops/lighting.py)
needs a plain per-voxel sigma field, and gets it by evaluating that
expression once at every voxel center: three banded-matrix resamples per
channel (ops/resample.py), then the combine.

Exact at voxel centers; a consumer then interpolates the combined field
where the reference interpolates each channel and then combines. The two
agree at voxel centers and differ by O(h^2) between them.
"""
from __future__ import annotations

import torch

from ..config import MediumConfig
from .resample import linear_resample_matrix

__all__ = ["materialize_sigma"]


def materialize_sigma(grid4, medium: MediumConfig, scroll=None,
                      address_mode="mirror"):
    """(D, H, W, 4) channel grid -> (D, H, W) float32 combined extinction
    sigma at voxel centers, including medium.sample_scale.

    scroll: optional (4, 3) per-channel scroll offsets in (x, y, z) coord
    order (ops/integrate.reference_media_scroll). Differentiable in grid4
    (three matrix products per channel)."""
    if grid4.dim() != 4 or grid4.shape[-1] < 4:
        raise ValueError("reference combine needs a (D, H, W, 4) grid")
    dev = grid4.device
    if scroll is not None:
        scroll = torch.as_tensor(scroll, dtype=torch.float32, device=dev)
    chans = []
    for c in range(4):
        sc = medium.channel_coord_scale[c]
        if scroll is not None:
            off = scroll[c] * medium.channel_scroll_weight[c]  # (3,) xyz
        else:
            off = torch.zeros(3, dtype=torch.float32, device=dev)
        g = grid4[..., c].to(torch.float32)
        # Grid dims are (z, y, x) = dims (0, 1, 2); the coord axis of grid
        # dim d is (2 - d) in the (x, y, z) offset vector.
        for dim in range(3):
            n = g.shape[dim]
            q01 = ((torch.arange(n, dtype=torch.float32, device=dev) + 0.5)
                   / n * sc + off[2 - dim])
            Wm = linear_resample_matrix(q01, n, address_mode)
            g = torch.movedim(torch.tensordot(Wm, g, dims=([1], [dim])),
                              0, dim)
        chans.append(g)
    s1, s2, s3, s4 = chans
    return (s1 * s2) * (s3 + s4) * medium.sample_scale
