"""Public rendering API of the PyTorch port (port of plan_for and
render_image / render from volumetricrenderer_tpu/render.py).

`render_image` renders one RGBA frame (H, W, 4) with the sliced-quadrature
slice sweep, differentiable in the grid: on a CUDA grid the forward runs
the hand-written forward sweep kernel and backward() the backward kernel,
on a CPU grid both run their plain PyTorch versions. The JAX package's
other paths through render_image (backend "reference", quadrature
"fixed", the per-ray fallback for cameras with no sweep axis, and the
shadow light volume) are not ported yet: asking for one raises
NotImplementedError. The per-ray integrators themselves are in
ops/integrate.py.
"""
from __future__ import annotations

from typing import Optional

from .config import LightConfig, MediumConfig, RenderConfig
from .ops.camera import Camera
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
    """Render one RGBA frame (H, W, 4) from a (D, H, W) density grid and a
    camera, on the grid's device."""
    if backend == "pallas":
        backend = "sweep"  # alias: the sweep kernel implements "sweep"
    if backend not in ("auto", "sweep", "reference"):
        raise ValueError(
            f"unknown backend {backend!r}: expected 'auto', 'sweep' "
            "(alias 'pallas'), or 'reference'")
    if backend == "reference":
        raise NotImplementedError(
            "backend 'reference' (the per-ray integrator) is not ported yet")
    if cfg.quadrature != "sliced":
        if backend == "sweep":
            raise ValueError('backend "sweep" requires quadrature "sliced"')
        raise NotImplementedError(
            f"quadrature {cfg.quadrature!r} (the per-ray march) is not "
            "ported yet; use quadrature='sliced'")
    if (light is not None and light.shadow_steps > 0 and light_volume is None
            and cfg.emission):
        raise NotImplementedError(
            "shadow light volumes (light.shadow_steps > 0) are not ported yet")
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
    return sweep_render(grid, plan, cfg, medium, light, scroll=scroll,
                        light_volume=light_volume)


# `render` is the stable public name.
render = render_image
