"""The per-ray march over a (data, slab) mesh (port of
volumetricrenderer_tpu/parallel/render_sharded.py): image rows split over
"data", the grid alike on every rank or split along z over "slab"
(spatial_grid, gathered before the march). No kernel runs on this path: it
is ops/integrate.render_rays on each rank's rows. Gradients follow
parallel/mesh.py's rule: each rank's grid gets the whole gradient of what
it holds, and a loss that the slab ranks of one row band each compute on
their (alike) rows counts once.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import LightConfig, MediumConfig, RenderConfig
from ..ops.integrate import render_rays
from .mesh import (DATA_AXIS, SLAB_AXIS, all_gather, mesh_ranks, replicas,
                   replicated)

__all__ = ["shard_rays", "make_sharded_renderer", "make_train_step"]


def shard_rays(origins, directions, mesh):
    """This rank's rows of per-pixel ray arrays (H, W, 3), rows padded to a
    multiple of the "data" size first (origins with 0, directions with 1:
    their pixels are discarded). Returns (origins, directions, pad)."""
    n_data, d, _, _ = mesh_ranks(mesh)
    pad = (-origins.shape[0]) % n_data
    if pad:
        origins = torch.cat([origins, origins.new_zeros(
            (pad, *origins.shape[1:]))])
        directions = torch.cat([directions, directions.new_ones(
            (pad, *directions.shape[1:]))])
    rows = origins.shape[0] // n_data
    return (origins[d * rows:(d + 1) * rows],
            directions[d * rows:(d + 1) * rows], pad)


def _whole_grid(grid, mesh, spatial_grid):
    """The whole grid on this rank, differentiable: split over "slab" and
    gathered (spatial_grid), else held alike by every rank."""
    if spatial_grid:
        return all_gather(replicated(grid, mesh.get_group(DATA_AXIS)),
                          mesh.get_group(SLAB_AXIS))
    return replicated(grid, dist.group.WORLD)


def make_sharded_renderer(mesh, cfg: RenderConfig, medium: MediumConfig,
                          light: Optional[LightConfig] = None,
                          spatial_grid: bool = False):
    """render_fn(grid, origins, directions, scroll=None) -> this rank's
    rows (shard_rays' rows) of the RGBA frame. grid: the whole grid, or
    with spatial_grid this rank's (D / n_slab, H, W[, C]) block of it
    along z."""
    n_slab = mesh_ranks(mesh)[2]

    def render_fn(grid, origins, directions, scroll=None):
        g = _whole_grid(grid, mesh, spatial_grid)
        img = render_rays(g, origins, directions, cfg, medium, light,
                          scroll=scroll)
        return replicas(img, n_slab)

    return render_fn


def make_train_step(mesh, cfg: RenderConfig, medium: MediumConfig, grid,
                    light: Optional[LightConfig] = None, optimizer=None,
                    learning_rate: float = 1e-2, spatial_grid: bool = False):
    """The inverse-rendering step of the per-ray march over the mesh:
    returns (step, optimizer). step(origins, directions, target) renders
    this rank's rows (shard_rays'), takes mean((rgb - target)^2) over all
    rows of the padded frame, backpropagates, applies the optimizer
    (torch.optim.Adam(lr=learning_rate) unless one is given) to grid (a
    leaf made to require grad, updated in place; this rank's block of it
    with spatial_grid), clamps it to [0, 1] and returns the loss, alike on
    every rank. target: this rank's (rows, W, 3) rows."""
    grid.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.Adam([grid], lr=learning_rate)
    n_data, _, n_slab, _ = mesh_ranks(mesh)
    render_fn = make_sharded_renderer(mesh, cfg, medium, light, spatial_grid)

    def step(origins, directions, target):
        optimizer.zero_grad(set_to_none=True)
        img = render_fn(grid, origins, directions)
        part = ((img[..., :3] - target) ** 2).sum() / (n_data
                                                        * target.numel())
        part.backward()
        optimizer.step()
        with torch.no_grad():
            grid.clamp_(0.0, 1.0)
        loss = part.detach().clone()
        if dist.get_world_size() > 1:
            loss = loss.cpu() if dist.get_backend() == "gloo" else loss
            dist.all_reduce(loss)
        return float(loss) / n_slab

    return step, optimizer
