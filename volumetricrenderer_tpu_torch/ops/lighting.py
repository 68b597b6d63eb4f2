"""Light-transmittance volume by a directional sweep (port of
volumetricrenderer_tpu/ops/lighting.py): the shadows of BASELINE config 4.

Instead of marching a secondary ray toward the light from every primary
sample (ops/integrate._light_transmittance), the volume's slices are swept
once from the light side inward, carrying the accumulated optical depth
and re-aligning it at every step with the light's constant shear:

    tau_s = Shift(tau_{s-1} + sigma_{s-1} * dl),     tau_0 = 0
    L_s   = exp(-density * tau_s)

`Shift` resamples by the light's inter-slice offset with zero weight
outside the box (no medium there): a constant two-tap shear along each
in-plane axis per step, O(volume) work per frame whatever the ray count. L is a per-voxel
transmittance grid; the slice sweep and the per-ray oracle then sample the
same L (sweep_render and render_rays_sliced take it as `light_volume`).

The scan runs in kernels/light_sweep.py: one hand-written CUDA kernel
forward and one for its adjoint on the card, its plain PyTorch version on
the CPU. The JAX package's step is two matrix products inside lax.scan;
here each shear is a table of two taps per line (the non-zeros of the
banded matrix), so a sweep is O(volume) work in one launch. Gradients flow
to the grid through the scan's node and the sigma construction.
"""
from __future__ import annotations

import numpy as np

from ..config import LightConfig, MediumConfig, RenderConfig
from ..kernels.light_sweep import LightSweep, light_sweep
from ..utils import clock
from .media import materialize_sigma
from .sweep import _axes_for

__all__ = ["light_transmittance_volume", "light_sweep_geometry"]


def light_sweep_geometry(light: LightConfig, cfg: RenderConfig,
                         medium: MediumConfig, shape):
    """(perm, LightSweep) of a (D, H, W) volume: the permutation that puts
    the sweep axis first (the volume's dominant axis toward the light) and
    the sweep's sign, shifts, dl and density, in float64 on the host."""
    # Light direction in normalized coords and the sweep's dominant axis.
    ldir = np.asarray(light.direction, np.float64)
    ldir = ldir / np.linalg.norm(ldir)
    box_min = np.asarray(cfg.box_min, np.float64)
    box_range = np.asarray(cfg.box_max, np.float64) - box_min
    w = ldir / box_range
    axis = int(np.argmax(np.abs(w)))
    sign = 1 if w[axis] > 0 else -1
    perm, (c_k, c_a, c_b) = _axes_for(axis)
    S = shape[perm[0]]

    # Inter-slice sample offset toward the light (normalized coords) and
    # the world-space path length of one slice step. The shifts round to
    # float32 where the texel centers are float32.
    dz = 1.0 / S
    shift_a = dz * w[c_a] / abs(w[axis])
    shift_b = dz * w[c_b] / abs(w[axis])
    rng = box_range[[c_k, c_a, c_b]]
    dl = dz * float(np.sqrt(
        rng[0] ** 2 + (shift_a / dz * rng[1]) ** 2
        + (shift_b / dz * rng[2]) ** 2))
    return perm, LightSweep(sign, float(np.float32(shift_a)),
                            float(np.float32(shift_b)), dl,
                            float(medium.density))


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

        perm, sweep = light_sweep_geometry(light, cfg, medium,
                                           tuple(sigma.shape))
        # Sweep from the light side inward; tau_s excludes the slice's own
        # density, as the shadow march starts sampling at step 1.
        L = light_sweep(sigma.permute(perm), sweep)  # (S, A, B)
        return L.permute(tuple(int(i) for i in np.argsort(perm)))
