"""Inverse rendering: fit a density grid to a target image by gradient
descent through the renderer (port of volumetricrenderer_tpu/fit.py, with
torch.optim.Adam's state in place of optax.adam's): a single-channel grid,
or the four channels of the reference medium.

Each step renders the grid, takes the image loss, backpropagates to the
voxels and applies one Adam update. With quadrature="sliced" the render is
the slice sweep, which on a CUDA grid runs the forward and backward sweep
kernels (the 4-channel ones for the reference medium); "fixed" is the
per-ray march of ops/integrate.py. The Adam update and the clamp are
kernels/adam_clamp.py: one kernel launch a step on a CUDA grid,
torch.optim.Adam's step and clamp_ on any other.

Spans (utils/clock.py): each step is the root "fit.step" (its request id
the step number), holding "fit.render" (the forward render and the loss),
"fit.backward" (loss.backward(): the backward sweep, the warp's splat, a
4-channel grid's channel layers, the gradient's zeroing and copies),
"fit.adam" (the update and the clamp), each with its device interval, and
two "fit.sync" (the NaN guard's check and the loss read back to the host:
the host waiting for the device). The first
"fit.sync" holds "fit.guard", the device interval of the guard's
finiteness reduction over the loss and every voxel's gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .config import LightConfig, MediumConfig, RenderConfig
from .kernels.adam_clamp import adam_clamp_step
from .kernels.build import NCH
from .ops.camera import Camera, camera_rays
from .ops.integrate import render_rays
from .utils import clock
from .utils.checkpoint import adam_state_from_leaves, adam_state_to_leaves
from .utils.metrics import MetricsWriter, get_logger

__all__ = ["FitResult", "fit_grid"]


@dataclasses.dataclass
class FitResult:
    grid: torch.Tensor
    losses: list
    steps: int
    skipped_steps: int = 0  # steps the NaN guard refused to apply


def _device_of(*xs, default):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(default)


def fit_grid(
    target_rgb,
    camera: Camera,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    grid_size: int = 64,
    steps: int = 200,
    learning_rate: float = 5e-2,
    init_grid=None,
    metrics: Optional[MetricsWriter] = None,
    checkpoint_fn: Optional[Callable] = None,
    checkpoint_every: int = 0,
    init_opt_state=None,
    start_step: int = 0,
    nan_guard: bool = True,
    device="cuda",
) -> FitResult:
    """Fit a density grid so the rendered image matches target_rgb
    (H, W, 3). Returns the fitted grid and the loss history.

    Without init_grid the fit starts from a grid of 0.1: (grid_size,) * 3
    for a single-channel medium, and (grid_size,) * 3 + (4,) for
    medium.combine "reference", whose four noise channels it fits. The
    grid's shape is init_grid's where one is given.

    The fit runs on the device of init_grid, else of target_rgb, when
    either is a tensor, and on `device` otherwise: "cuda" unless the caller
    asks for another, so without a GPU the default raises torch's own error
    and only device="cpu" gets the CPU. The loss is
    mean((rgb - target)^2); after each Adam step (lr = learning_rate,
    betas (0.9, 0.999), eps 1e-8, as optax.adam) the grid is clamped to
    [0, 1].

    checkpoint_fn(step, grid, opt_state), when given with
    checkpoint_every > 0, is called after every checkpoint_every-th step
    with the optimizer state as optax.adam's leaves (count, mu, nu). To
    resume, pass init_grid, init_opt_state (those leaves) and start_step
    from utils.checkpoint.restore_checkpoint; steps counts total steps, so
    a resumed run executes steps - start_step more and continues the Adam
    state where it stopped.

    nan_guard: a step whose loss or gradients are not finite applies no
    update, leaving the grid and the Adam state as they were; such steps
    are counted in skipped_steps."""
    dev = _device_of(init_grid, target_rgb, default=device)
    target = torch.as_tensor(target_rgb, dtype=torch.float32, device=dev)
    if init_grid is None:
        channels = (NCH,) if medium.combine == "reference" else ()
        grid = torch.full((grid_size,) * 3 + channels, 0.1,
                          dtype=torch.float32, device=dev)
    else:
        grid = torch.as_tensor(init_grid, dtype=torch.float32,
                               device=dev).clone()
    grid.requires_grad_(True)

    optimizer = torch.optim.Adam([grid], lr=learning_rate)
    if init_opt_state is not None:
        optimizer.state[grid] = adam_state_from_leaves(init_opt_state, grid)

    if cfg.quadrature == "sliced":
        from .ops.sweep import sweep_render
        from .render import plan_for
        plan = plan_for(camera, grid.shape, cfg, device=dev)

        def render(g):
            return sweep_render(g, plan, cfg, medium, light)
    else:
        origins, directions = (t.to(dev) for t in camera_rays(camera))

        def render(g):
            return render_rays(g, origins, directions, cfg, medium, light)

    log = get_logger()
    losses = []
    if start_step >= steps:
        # Resuming a completed fit (the CLI checkpoints at step == steps):
        # nothing left to do.
        log.info("fit already complete at step %d/%d", start_step, steps)
        return FitResult(grid=grid.detach(), losses=losses, steps=steps)
    skipped = 0
    for i in range(start_step, steps):
        with clock.root("fit.step", request=i):
            optimizer.zero_grad(set_to_none=True)
            with clock.span("fit.render", device=grid):
                loss = torch.mean((render(grid)[..., :3] - target) ** 2)
            with clock.span("fit.backward", device=grid):
                loss.backward()
            ok = True
            if nan_guard:
                with clock.span("fit.sync"):
                    with clock.span("fit.guard", device=grid):
                        finite = (torch.isfinite(loss)
                                  & torch.isfinite(grid.grad).all())
                    ok = bool(finite)
            if ok:
                with clock.span("fit.adam", device=grid):
                    adam_clamp_step(optimizer, grid, 0.0, 1.0)
            with clock.span("fit.sync"):
                losses.append(float(loss.detach()))
            if not ok:
                skipped += 1
                log.warning("fit step %d skipped: non-finite loss/gradients "
                            "(loss=%r)", i, losses[-1])
            if metrics is not None and (i % 10 == 0 or i == steps - 1):
                metrics.write(step=i, loss=losses[-1])
            if checkpoint_fn and checkpoint_every \
                    and (i + 1) % checkpoint_every == 0:
                checkpoint_fn(i + 1, grid.detach(),
                              adam_state_to_leaves(optimizer, grid))
    if skipped:
        log.warning("fit: %d/%d steps skipped by the NaN guard", skipped,
                    steps - start_step)
    log.info("fit finished: %d steps, loss %.6f -> %.6f",
             steps - start_step, losses[0], losses[-1])
    return FitResult(grid=grid.detach(), losses=losses, steps=steps,
                     skipped_steps=skipped)
