"""Light-transmittance volume by a directional sweep (port of
volumetricrenderer_tpu/ops/lighting.py): the shadows of BASELINE config 4.

Instead of marching a secondary ray toward the light from every primary
sample (ops/integrate._light_transmittance), the volume's slices are swept
once from the light side inward, carrying the accumulated optical depth
and re-aligning it at every step with the light's constant shear:

    tau_s = Shift(tau_{s-1} + sigma_{s-1} * dl),     tau_0 = 0
    L_s   = exp(-density * tau_s)

`Shift` resamples by the light's inter-slice offset with zero weight
outside the box (no medium there): two constant banded matrices per step,
O(volume) work per frame whatever the ray count. L is a per-voxel
transmittance grid; the slice sweep and the per-ray oracle then sample the
same L (sweep_render and render_rays_sliced take it as `light_volume`).

The two products of a step are plain matrix products in the JAX package
too, outside any kernel, so they are torch.matmul here; the scan is a
Python loop of S - 1 sequential steps. Gradients flow to the grid by
autograd.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import LightConfig, MediumConfig, RenderConfig
from ..utils import clock
from .media import materialize_sigma
from .resample import linear_resample_matrix
from .sweep import _axes_for

__all__ = ["light_transmittance_volume"]


def light_transmittance_volume(grid, light: LightConfig, cfg: RenderConfig,
                               medium: MediumConfig, scroll=None):
    """Per-voxel transmittance toward a directional light, (D, H, W) in
    [0, 1], on the grid's device. combine="single" uses channel 0
    directly; the 4-channel reference combine first materializes the
    combined sigma field at voxel centers (ops/media.materialize_sigma).
    Differentiable in the grid. Span "light.sweep" (utils/clock.py): the
    host's time to enqueue the sweep, not synchronized."""
    with clock.span("light.sweep"):
        if medium.combine == "reference":
            sigma = materialize_sigma(grid, medium, scroll, cfg.address_mode)
        elif medium.combine == "single":
            g = grid[..., 0] if grid.dim() == 4 else grid
            sigma = g * medium.sample_scale
        else:
            raise ValueError(f"unknown combine mode {medium.combine!r}")

        # Light direction in normalized coords and the sweep's dominant axis,
        # in float64 on the host.
        ldir = np.asarray(light.direction, np.float64)
        ldir = ldir / np.linalg.norm(ldir)
        box_min = np.asarray(cfg.box_min, np.float64)
        box_range = np.asarray(cfg.box_max, np.float64) - box_min
        w = ldir / box_range
        axis = int(np.argmax(np.abs(w)))
        sign = 1 if w[axis] > 0 else -1
        perm, (c_k, c_a, c_b) = _axes_for(axis)

        gperm = sigma.permute(perm)  # (S, A, B)
        S, A, B = gperm.shape
        dev = gperm.device

        # Inter-slice sample offset toward the light (normalized coords) and
        # the world-space path length of one slice step.
        dz = 1.0 / S
        shift_a = dz * w[c_a] / abs(w[axis])
        shift_b = dz * w[c_b] / abs(w[axis])
        rng = box_range[[c_k, c_a, c_b]]
        dl = dz * float(np.sqrt(
            rng[0] ** 2 + (shift_a / dz * rng[1]) ** 2
            + (shift_b / dz * rng[2]) ** 2))

        # Constant shear matrices: resample the carried optical depth from the
        # previous (light-side) slice at positions offset toward the light.
        # The shifts round to float32 where the texel centers are float32.
        def shear(n, shift):
            x01 = (torch.arange(n, dtype=torch.float32, device=dev)
                   + 0.5) / n + float(np.float32(shift))
            return linear_resample_matrix(x01, n, "zero", zero_outside=True)

        Wa, WbT = shear(A, shift_a), shear(B, shift_b).T

        # Sweep from the light side inward: sign > 0 means the light lies
        # toward +k, so the highest-k slice is lit first. tau_s excludes the
        # slice's own density, as the shadow march starts sampling at step 1.
        # (unbind, not gperm[k]: its backward stacks the slices' gradients
        # once, where S selects would each fill a whole zero volume.)
        order = list(range(S - 1, -1, -1) if sign > 0 else range(S))
        slices = gperm.unbind(0)
        tau = torch.zeros((A, B), dtype=torch.float32, device=dev)
        taus = [None] * S
        taus[order[0]] = tau
        for k_prev, k in zip(order, order[1:]):
            tau = Wa @ (tau + slices[k_prev] * dl) @ WbT
            taus[k] = tau
        L = torch.exp(-medium.density * torch.stack(taus))
        return L.permute(tuple(int(i) for i in np.argsort(perm)))
