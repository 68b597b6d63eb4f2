"""Public rendering API of the PyTorch port (port of plan_for and
render_image / render from volumetricrenderer_tpu/render.py).

`render_image` renders one RGBA frame (H, W, 4) with the sliced-quadrature
slice sweep, differentiable in the grid: on a CUDA grid the forward runs
a hand-written forward sweep kernel and backward() its backward kernel,
on a CPU grid both run their plain PyTorch versions. A (D, H, W) grid with
combine="single" goes through the single-channel kernels, a (D, H, W, 4)
grid with combine="reference" (and an optional per-channel scroll) through
the 4-channel reference-combine kernels. backend="reference" renders the
same sliced integral per ray with ops/integrate.render_rays_sliced, the
sweep's oracle. With emission and light.shadow_steps > 0 (BASELINE config
4) the frame is shadowed: one light-propagation sweep per frame
(ops/lighting.light_transmittance_volume) builds the light volume that
both backends then sample. The JAX package's other paths through
render_image (quadrature "fixed" and the per-ray fallback for cameras with
no sweep axis) are not ported yet: asking for one raises
NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

from .config import LightConfig, MediumConfig, RenderConfig
from .ops.camera import Camera, camera_rays
from .ops.integrate import render_rays_sliced
from .ops.lighting import light_transmittance_volume
from .ops.sweep import SweepPlan, plan_sweep, sweep_render

__all__ = ["render", "render_image", "plan_for"]


def plan_for(camera: Camera, grid_shape, cfg: RenderConfig,
             world_to_local=None, n_slices=None, device=None) -> SweepPlan:
    """Build the sweep plan for a camera/volume/config triple, with its
    arrays on `device`. Callers rendering many frames from one camera build
    the plan once and pass it to render_image."""
    return plan_sweep(camera, grid_shape, cfg,
                      world_to_local=world_to_local,
                      supersample=cfg.sweep_supersample,
                      n_slices=n_slices, device=device)


def render_image(
    grid,
    camera: Camera,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    world_to_local=None,
    backend: str = "auto",
    plan: Optional[SweepPlan] = None,
    light_volume=None,
):
    """Render one RGBA frame (H, W, 4) from a density grid and a camera, on
    the grid's device.

    grid: (D, H, W) with medium.combine "single", or (D, H, W, 4) with
    "reference"; scroll: optional (4, 3) per-channel scroll of the
    reference medium (ops/integrate.reference_media_scroll). backend "auto"
    and "sweep" (alias "pallas") run the slice sweep, "reference" the
    per-ray oracle of the same sliced quadrature. light_volume: a
    precomputed (D, H, W) light-transmittance grid; when it is None,
    cfg.emission is set and light.shadow_steps > 0, it is built from the
    grid here, once per frame, and the frame's gradient reaches the grid
    through it too."""
    if backend == "pallas":
        backend = "sweep"  # alias: the sweep kernel implements "sweep"
    if backend not in ("auto", "sweep", "reference"):
        raise ValueError(
            f"unknown backend {backend!r}: expected 'auto', 'sweep' "
            "(alias 'pallas'), or 'reference'")
    if cfg.quadrature != "sliced":
        if backend == "sweep":
            raise ValueError('backend "sweep" requires quadrature "sliced"')
        raise NotImplementedError(
            f"quadrature {cfg.quadrature!r} (the per-ray march) is not "
            "ported yet; use quadrature='sliced'")
    if (light is not None and light.shadow_steps > 0 and light_volume is None
            and cfg.emission):
        # Config-4 shadows: one light-propagation sweep per frame instead
        # of a nested march per sample.
        light_volume = light_transmittance_volume(grid, light, cfg, medium,
                                                  scroll=scroll)
    if plan is None:
        try:
            plan = plan_for(camera, grid.shape, cfg, world_to_local,
                            device=grid.device)
        except ValueError as e:
            if backend == "sweep":
                raise
            raise NotImplementedError(
                f"no sweep axis for this camera ({e}); the per-ray fallback "
                "integrator is not ported yet") from e
    if backend == "reference":
        origins, directions = (r.to(grid.device)
                               for r in camera_rays(camera))
        return render_rays_sliced(grid, origins, directions, plan, cfg,
                                  medium, light, scroll=scroll,
                                  light_volume=light_volume)
    return sweep_render(grid, plan, cfg, medium, light, scroll=scroll,
                        light_volume=light_volume)


# `render` is the stable public name.
render = render_image
