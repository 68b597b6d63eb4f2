"""Public rendering API of the PyTorch port (port of
volumetricrenderer_tpu/render.py: plan_for, render_image / render,
prepare_baked_scene, render_scene, render_preset).

`render_image` renders one RGBA frame (H, W, 4), differentiable in the
grid. RenderConfig.quadrature selects the math, `backend` the
implementation:

  quadrature "sliced" (the staged BASELINE configs):
    * "sweep" (alias "pallas"): the slice sweep (ops/sweep.py). On a CUDA
      grid the forward runs a hand-written forward sweep kernel and
      backward() its backward kernel, on a CPU grid both run their plain
      PyTorch versions. A (D, H, W) or (D, H, W, 1) grid with
      combine="single" goes through the single-channel kernels, a
      (D, H, W, 4) grid with combine="reference" (and an optional
      per-channel scroll) through the 4-channel reference-combine kernels;
      RenderConfig(dtype="bfloat16") selects their bfloat16 stream mode.
    * "reference": the per-ray oracle of the same sliced integral
      (ops/integrate.render_rays_sliced).
  quadrature "fixed" (the `reference` preset as it is defined): the per-ray
  fixed-step march (ops/integrate.render_rays), a Python loop of gathers
  per step. The same preset with quadrature "sliced" (`cli render`,
  `animate`, `serve --quadrature sliced`) takes the 4-channel sweep.
  backend "auto" takes the sweep for "sliced", falling back (loudly) to the
  per-ray march when the camera admits no sweep axis, and the march for
  "fixed".

With emission and light.shadow_steps > 0 the sliced frame is shadowed
(BASELINE config 4): one light-propagation sweep per frame
(ops/lighting.light_transmittance_volume) builds the light volume that both
backends then sample.

`render_scene` renders a multi-volume scene (BASELINE config 3), baked onto
one grid for the sweep or marched against the exact per-volume fields;
`render_preset` renders a named preset at an animation time. Functions that
take a grid run on the grid's device; `render_preset` and `plan_for` create
their own tensors and do so on `device`, "cuda" unless the caller asks
otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import LightConfig, MediumConfig, Preset, RenderConfig
from .models import scene as scene_mod
from .models.scene import Volume, bake_scene, build_volume
from .ops.camera import Camera, camera_rays, make_camera
from .ops.integrate import (reference_media_scroll, render_rays,
                            render_rays_sliced, scene_sigma)
from .ops.lighting import light_transmittance_volume
from .ops.media import materialize_sigma
from .ops.sweep import SweepPlan, plan_sweep, sweep_render
from .utils import clock
from .utils.metrics import get_logger

__all__ = ["render", "render_preset", "render_image", "render_scene",
           "prepare_baked_scene", "plan_for"]


def plan_for(camera: Camera, grid_shape, cfg: RenderConfig,
             world_to_local=None, n_slices=None,
             device="cuda") -> SweepPlan:
    """Build the sweep plan for a camera/volume/config triple, with its
    arrays on `device`, "cuda" unless the caller asks for another (without
    a GPU the default raises torch's own error). Callers rendering many
    frames from one camera build the plan once and pass it to
    render_image."""
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

    grid: (D, H, W) or (D, H, W, 1) with medium.combine "single", or
    (D, H, W, 4) with "reference"; scroll: optional (4, 3) per-channel
    scroll of the reference medium (ops/integrate.reference_media_scroll).
    Quadratures and backends as the module docstring lists them.
    light_volume: a precomputed (D, H, W) light-transmittance grid; when it
    is None, the quadrature is "sliced", cfg.emission is set and
    light.shadow_steps > 0, it is built from the grid here, once per frame,
    and the frame's gradient reaches the grid through it too (the "fixed"
    march casts its own shadow rays). The frame is the root span
    "render.image" (utils/clock.py)."""
    with clock.root("render.image"):
        if backend == "pallas":
            backend = "sweep"  # alias: the sweep kernel implements "sweep"
        if backend not in ("auto", "sweep", "reference"):
            # A mistyped backend must not silently select the per-ray march.
            raise ValueError(
                f"unknown backend {backend!r}: expected 'auto', 'sweep' "
                "(alias 'pallas'), or 'reference'")
        if (cfg.quadrature == "sliced" and light is not None
                and light.shadow_steps > 0 and light_volume is None
                and cfg.emission):
            # Config-4 shadows: one light-propagation sweep per frame
            # instead of a nested march per sample.
            light_volume = light_transmittance_volume(grid, light, cfg,
                                                      medium, scroll=scroll)
        if cfg.quadrature == "sliced":
            if plan is None:
                try:
                    plan = plan_for(camera, grid.shape, cfg, world_to_local,
                                    device=grid.device)
                except ValueError as e:
                    if backend == "sweep":
                        raise
                    # Loud: the per-ray march is a Python loop of gathers
                    # per step, far slower than the sweep; never take it
                    # silently.
                    get_logger().warning(
                        "no sweep axis for this camera (%s); falling back to "
                        "the per-ray gather integrator: expect a large "
                        "slowdown", e)
                    plan = None
            if plan is not None:
                if backend in ("auto", "sweep"):
                    return sweep_render(grid, plan, cfg, medium, light,
                                        scroll=scroll,
                                        light_volume=light_volume)
                origins, directions = _rays(camera, grid.device)
                return render_rays_sliced(grid, origins, directions, plan,
                                          cfg, medium, light, scroll=scroll,
                                          light_volume=light_volume)
            # No sweep axis (extreme field of view): the fixed-step march.
        elif backend == "sweep":
            raise ValueError('backend "sweep" requires quadrature "sliced"')
        origins, directions = _rays(camera, grid.device)
        return render_rays(grid, origins, directions, cfg, medium, light,
                           scroll=scroll, world_to_local=world_to_local)


def _rays(camera: Camera, device):
    return tuple(r.to(device) for r in camera_rays(camera))


# `render` is the stable public name.
render = render_image


def prepare_baked_scene(volumes, cfg: RenderConfig, medium: MediumConfig,
                        scroll=None, bake_size=None):
    """Bake a multi-volume scene onto one shared grid for the single-grid
    sweep; returns (grid, medium, scroll) ready for render_image.

    With the 4-channel reference combine each volume's combined sigma is
    first materialized at voxel centers (ops/media.py: the scroll folds
    into the materialization), then the scalar fields bake as usual
    (overlapping sigmas add) and the returned medium is the equivalent
    single-channel one, with no scroll left."""
    volumes = [v if isinstance(v, Volume) else Volume(v) for v in volumes]
    if medium.combine == "reference":
        volumes = [
            Volume(materialize_sigma(v.grid, medium, scroll,
                                     cfg.address_mode), v.world_to_local)
            for v in volumes]
        medium = dataclasses.replace(medium, combine="single",
                                     sample_scale=1.0)
        scroll = None
    size = bake_size or max(max(v.grid.shape[:3]) for v in volumes)
    return bake_scene(volumes, size, cfg), medium, scroll


def render_scene(
    volumes,
    camera: Camera,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    backend: str = "auto",
    bake_size: Optional[int] = None,
    plan: Optional[SweepPlan] = None,
):
    """Render a multi-volume scene: N density grids, each with its own
    world transform (models.scene.Volume), composited as independent
    scatterers (densities add where volumes overlap), on the volumes'
    device. BASELINE config 3 is a cloud + smoke two-volume scene.

    backend "auto"/"sweep" with the sliced quadrature bakes the scene onto
    one shared grid (models.scene.bake_scene: once per scene, exact for
    voxel-aligned translations) and runs the slice sweep, so a CUDA scene
    goes through the sweep kernels; backend "reference" marches rays
    against the exact per-volume fields (ops/integrate.scene_sigma:
    arbitrary affines, no bake error)."""
    volumes = [v if isinstance(v, Volume) else Volume(v) for v in volumes]
    if medium.combine not in ("single", "reference"):
        raise ValueError(f"unknown combine mode {medium.combine!r}")
    if backend in ("auto", "sweep") and cfg.quadrature == "sliced":
        grid, bake_medium, scroll = prepare_baked_scene(
            volumes, cfg, medium, scroll=scroll, bake_size=bake_size)
        return render_image(grid, camera, cfg, bake_medium, light,
                            scroll=scroll, backend=backend, plan=plan)
    dev = volumes[0].grid.device
    origins, directions = _rays(camera, dev)

    def sigma(pos):
        return scene_sigma(volumes, pos, cfg, medium, scroll)

    if cfg.quadrature == "sliced":
        size = bake_size or max(max(v.grid.shape[:3]) for v in volumes)
        if plan is None:
            plan = plan_for(camera, (size,) * 3, cfg, device=dev)
        return render_rays_sliced(None, origins, directions, plan, cfg,
                                  medium, light, scroll=scroll,
                                  sigma_fn=sigma)
    return render_rays(None, origins, directions, cfg, medium, light,
                       scroll=scroll, sigma_fn=sigma)


def render_preset(preset: Preset, t: float = 0.0, grid=None,
                  backend: str = "auto", plan: Optional[SweepPlan] = None,
                  device="cuda"):
    """Render a named BASELINE preset at animation time t (seconds), which
    drives the media scroll.

    The preset's volume (or scene) is built on `device`, "cuda" by default:
    without a GPU that raises torch's own error, and only a caller who
    passes device="cpu" gets the CPU. A `grid` passed in is rendered on its
    own device. The single-channel presets' (D, H, W, 1) grids take the
    single-channel sweep kernels (ops/sweep.sweep_render), config 3 bakes
    its scene and takes them too, and the `reference` preset marches per
    ray under its own quadrature ("fixed") and takes the 4-channel sweep
    kernels under quadrature "sliced"."""
    dev = torch.device(device) if grid is None else grid.device
    cam = make_camera(preset.camera)
    if grid is None and preset.scene:
        volumes = getattr(scene_mod, preset.scene)(preset.volume.size,
                                                   device=dev)
        return render_scene(volumes, cam, preset.render, preset.medium,
                            preset.light, backend=backend, plan=plan)
    if grid is None:
        grid = build_volume(preset.volume, device=dev)
    n_channels = grid.shape[-1] if grid.dim() == 4 else 1
    scroll = reference_media_scroll(t, n_channels=max(n_channels, 1),
                                    device=dev)
    return render_image(grid, cam, preset.render, preset.medium,
                        preset.light, scroll=scroll, backend=backend,
                        plan=plan)
