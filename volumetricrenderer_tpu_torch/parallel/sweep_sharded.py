"""The slice sweep over a (data, slab) mesh, forward and backward (port of
volumetricrenderer_tpu/parallel/sweep_sharded.py; BASELINE config 5).

  * slab: the volume is split along the plan's sweep axis in k order; each
    rank sweeps only its own block of slices, with the sweep kernels of
    kernels/sweep_fwd.py (K1, K2) or kernels/sweep_ref_fwd.py (K4, K5) on
    a CUDA block and their plain versions on a CPU block. Front-to-back
    compositing is an associative monoid (ops/sweep.composite_base_maps),
    so no ray carries anything across a slab boundary: the slab partials
    combine afterwards, by a butterfly of log2(n) exchanges for a
    power-of-two slab count, else by a gather and an ordered fold.
  * data: base-grid rows and screen-pixel rows split over "data"; each
    rank sweeps its own base rows, gathers the base maps and warps its own
    band of pixel rows.
  * the grid arrives split along storage z over "slab" (each rank holds
    its (D / n_slab, H, W[, C]) block, alike on every data rank); when the
    sweep axis is not z one all-to-all over "slab" regroups it along the
    sweep axis. What needs layers of other slabs, the sub-voxel lerp
    (n_slices != depth), the reference medium's channel slabs and the light
    stack, is built from the gathered volume for this rank's slices.

Every collective is explicit (parallel/mesh.py) and differentiable, so
backward() through a frame runs K2 (or K5) on each rank's block and returns
each rank the gradient of its own grid block. The frame each rank returns
is its band of pixel rows (frame_rows), held alike by the ranks of its
slab group: a loss each of them computes on its band counts once
(parallel/mesh.py states the rule).

The early-stop gate reads a slab's own transmittance, which starts at 1 at
the slab's front: skipping once it is below eps changes that slab's partial
by less than eps, and the composite scales it by the prefix transmittance
(<= 1), so the sharded frame is within ~eps of the unsharded one, and
exact with the gate off (early_stop_transmittance = -1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..config import LightConfig, MediumConfig, RenderConfig
from ..kernels import build, sweep_fwd
from ..kernels.sweep_fwd import _layer_lerp_stack, _params_for, _SweepFwd
from ..kernels.sweep_ref_fwd import (_channel_offsets, _layer_channels,
                                     _params_ref, sweep_ref_apply)
from ..ops.lighting import light_transmittance_volume
from ..ops.sweep import (_sweep_base, composite_base_maps, postwarp_pixels,
                         sweep_config, warp_base_to_pixels, warp_inputs)
from .mesh import (DATA_AXIS, SLAB_AXIS, all_gather, all_to_all, exchange,
                   gather_replicated, mesh_ranks, replicas, replicated)

__all__ = ["sweep_render_sharded", "make_sweep_train_step", "frame_rows",
           "local_plan", "local_sweep", "split_inputs", "split_sweep"]


@dataclasses.dataclass(frozen=True)
class LocalPlan:
    """One rank's part of a plan: its block of slices in k order
    (slice_k) and front to back (slice_z), its base rows [r0, r1) of
    v_grid and seglen, and its pixel rows [h0, h1) of the frame with the
    number of ranks that hold them (`holders`) and the plan of those rows
    (`warp_plan`)."""

    slice_k: torch.Tensor
    slice_z: torch.Tensor
    v_grid: torch.Tensor
    seglen: torch.Tensor
    r0: int
    r1: int
    h0: int
    h1: int
    holders: int
    warp_plan: object


_LOCAL = build.IdentityCache()


def local_plan(plan, n_slab: int, slab_rank: int, n_data: int = 1,
               data_rank: int = 0) -> LocalPlan:
    """The LocalPlan of block (slab_rank, data_rank) of plan, made once per
    plan and block: the kernels' per-plan caches (stage sizing) key on
    these tensors, so a reused plan reads nothing back per frame. Raises
    ValueError when n_slab does not divide the slices or n_data the base
    rows."""
    S = plan.slice_z.shape[0]
    Hb = plan.v_grid.shape[0]
    if S % n_slab:
        raise ValueError(f"sharded sweep: {n_slab} slabs do not divide "
                         f"{S} slices")
    if Hb % n_data:
        raise ValueError(f"sharded sweep: {n_data} data ranks do not "
                         f"divide {Hb} base rows")

    def make():
        s_loc, rows = S // n_slab, Hb // n_data
        slice_k = plan.slice_z if plan.sign > 0 else plan.slice_z.flip(0)
        slice_k = slice_k[slab_rank * s_loc:(slab_rank + 1) * s_loc] \
            .contiguous()
        slice_z = slice_k if plan.sign > 0 else slice_k.flip(0)
        r0, r1 = data_rank * rows, (data_rank + 1) * rows
        H = plan.warp_rows01.shape[0]
        if H % n_data:
            h0, h1, holders = 0, H, n_slab * n_data
        else:
            h0, h1 = data_rank * H // n_data, (data_rank + 1) * H // n_data
            holders = n_slab
        warp_plan = dataclasses.replace(
            plan, warp_rows01=plan.warp_rows01[h0:h1],
            warp_cols01=plan.warp_cols01[h0:h1])
        return LocalPlan(slice_k, slice_z.contiguous(), plan.v_grid[r0:r1],
                         plan.seglen[r0:r1], r0, r1, h0, h1, holders,
                         warp_plan)
    return _LOCAL.get((plan.slice_z, plan.v_grid, plan.seglen,
                       plan.warp_rows01),
                      (n_slab, slab_rank, n_data, data_rank), make)


def frame_rows(plan, mesh):
    """(h0, h1, holders): the pixel rows [h0, h1) of the frame this rank's
    sweep_render_sharded returns, and how many ranks return them. The rows
    split over "data" when it divides the frame's height; else every rank
    returns the whole frame."""
    n_data, d, n_slab, s = mesh_ranks(mesh)
    lp = local_plan(plan, n_slab, s, n_data, d)
    return lp.h0, lp.h1, lp.holders


def local_sweep(stack, chan, lstack, lp: LocalPlan, plan,
                cfg: RenderConfig, medium: MediumConfig,
                light: Optional[LightConfig], scroll,
                chunk: Optional[int] = None,
                use_kernels: Optional[bool] = None):
    """One rank's sweep: the (acc, trans, wsum, hit) base maps, each
    (r1 - r0, Wb), of its block of slices and rows, before the slabs are
    composited. The per-rank body of sweep_render_sharded, with no
    collective.

    stack: this block of the grid permuted to the sweep axis, (S / n_slab,
    A, B) in k order (combine "single"); chan: the reference medium's
    channel slabs (S / n_slab, 4, A, B) in k order (combine "reference");
    lstack: the light stack (S / n_slab, A, B) in k order, or None. On
    CUDA tensors the kernels run (K1/K2 or K4/K5), on CPU tensors their
    plain versions; the reference medium with clamp or wrap addressing,
    which no kernel covers, takes the general sweep on the block.
    chunk, use_kernels: as ops/sweep.sweep_render takes them."""
    lt = light if light is not None else LightConfig()
    flip = plan.sign < 0
    covered = chan is None or sweep_fwd.supported(cfg, medium, lstack,
                                                  scroll, 4)
    if use_kernels and not covered:
        raise NotImplementedError(
            "local_sweep(use_kernels=True): no kernel covers combine="
            f"{medium.combine!r} with address_mode={cfg.address_mode!r}")
    general = use_kernels is False or not covered
    if chan is None and not general:
        if stack.device.type == "cuda":
            stack = stack.contiguous()
            lstack = None if lstack is None else lstack.contiguous()
        return _SweepFwd.apply(stack, lstack, lp.slice_z, lp.v_grid,
                               plan.u_grid, lp.seglen,
                               _params_for(plan, cfg, medium, lt),
                               cfg.emission, flip, cfg.address_mode,
                               cfg.dtype == "bfloat16")
    # the channel slabs (or the single combine's layers) and the light slabs
    # in slice_z order
    L = stack if chan is None else chan
    L = L.flip(0) if flip else L
    slabs = None if lstack is None else (lstack.flip(0) if flip else lstack)
    if general:
        return _sweep_base(None, None, lp.slice_z, lp.v_grid, plan.u_grid,
                           lp.seglen, plan, cfg, medium, light, scroll,
                           chan_slabs=L, light_slabs=slabs, chunk=chunk)
    if L.device.type == "cuda":
        L = L.contiguous()
        slabs = None if slabs is None else slabs.contiguous()
    offs = _channel_offsets(medium, scroll, plan.coord_order, device=L.device)
    return sweep_ref_apply(L, slabs, lp.slice_z, lp.v_grid, lp.seglen,
                           _params_ref(plan, cfg, medium, lt, offs), plan,
                           cfg, medium, light)


def _block_stacks(gperm, k_block, lperm, lp: LocalPlan, plan,
                  cfg: RenderConfig, medium: MediumConfig, scroll,
                  slab_rank: int):
    """(stack, chan, lstack) of local_sweep for one block, from the whole
    volume permuted to the sweep axis (gperm: (D, A, B[, C]), in k order)
    or, when only the block's own layers are needed (combine "single" with
    a slice per layer), from k_block, the block itself. lperm: the whole
    light volume permuted likewise, or None. The lerps run for this
    block's slices only; each slice's value is the one the whole stack
    would hold."""
    s_loc = lp.slice_k.shape[0]
    lo, hi = slab_rank * s_loc, (slab_rank + 1) * s_loc
    stack = chan = lstack = None
    if medium.combine == "reference":
        offs = _channel_offsets(medium, scroll, plan.coord_order,
                                device=gperm.device)
        chan = _layer_channels(gperm, lp.slice_k, medium, offs,
                               cfg.address_mode)
    elif k_block is not None:
        stack = k_block
    elif gperm.shape[0] == plan.slice_z.shape[0]:
        stack = gperm[lo:hi]
    else:
        stack = _layer_lerp_stack(gperm, lp.slice_k, cfg.address_mode)
    if lperm is not None:
        if medium.combine == "single" and \
                lperm.shape[0] == plan.slice_z.shape[0]:
            lstack = lperm[lo:hi]  # the grid's own layers, as unsharded
        else:
            lstack = _layer_lerp_stack(lperm, lp.slice_k, cfg.address_mode)
    return stack, chan, lstack


def _prepare(grid, shape, medium: MediumConfig, cfg: RenderConfig, scroll,
             light_volume):
    """ops/sweep.sweep_config for a block of a grid of the whole `shape`:
    (grid, scroll, light_volume). Raises ValueError for a light volume of
    another shape than the grid's (the JAX package's sharded sweep refuses
    it)."""
    grid, scroll, light_volume, _ = sweep_config(grid, cfg, medium, scroll,
                                                 light_volume, shape)
    if light_volume is not None and \
            tuple(light_volume.shape) != tuple(shape[:3]):
        raise ValueError("sharded sweep: light_volume must match the grid's "
                         f"spatial shape {tuple(shape[:3])}, got "
                         f"{tuple(light_volume.shape)}")
    return grid, scroll, light_volume


def split_inputs(grid, plan, cfg: RenderConfig, medium: MediumConfig,
                 n_slab: int, slab_rank: int, n_data: int = 1,
                 data_rank: int = 0, scroll=None, light_volume=None):
    """local_sweep's inputs for block (slab_rank, data_rank) cut from the
    whole grid (and light volume) in one process, with no process group:
    (stack, chan, lstack, local plan). Differentiable in the grid and the
    light volume. Compositing the blocks' maps front to back
    (composite_base_maps) gives the unsharded sweep's maps."""
    grid, scroll, light_volume = _prepare(grid, tuple(grid.shape), medium,
                                          cfg, scroll, light_volume)
    lp = local_plan(plan, n_slab, slab_rank, n_data, data_rank)
    perm = plan.perm + ((3,) if grid.dim() == 4 else ())
    lperm = None if light_volume is None else light_volume.permute(plan.perm)
    return (*_block_stacks(grid.permute(perm), None, lperm, lp, plan, cfg,
                           medium, scroll, slab_rank), lp)


def split_sweep(grid, plan, cfg: RenderConfig, medium: MediumConfig,
                n_slab: int, n_data: int = 1, scroll=None, light_volume=None):
    """The sharded sweep's arithmetic in one process, with no process
    group: local_sweep on every (slab, data) block of the whole grid
    (split_inputs), each row block's slab partials composited front to
    back, the row blocks stacked. Returns the (acc, trans, wsum, hit) base
    maps of the whole plan, differentiable in the grid and the light
    volume; on CUDA tensors n_slab * n_data launches of each kernel."""
    rows = []
    for d in range(n_data):
        parts = []
        for s in range(n_slab):
            stack, chan, lstack, lp = split_inputs(
                grid, plan, cfg, medium, n_slab, s, n_data, d, scroll,
                light_volume)
            parts.append(local_sweep(stack, chan, lstack, lp, plan, cfg,
                                     medium, None, scroll))
        if plan.sign < 0:
            parts = parts[::-1]
        out = parts[0]
        for far in parts[1:]:
            out = composite_base_maps(out, far)
        rows.append(out)
    return tuple(torch.cat([r[k] for r in rows]) for k in range(4))


def _composite_slabs(maps, n_slab: int, sign: int, slab_rank: int, group):
    """Every rank's front-to-back composite of the slab partials over the
    slab group.

    A power-of-two count runs a recursive-doubling butterfly: at step s
    each rank swaps its composite with rank ^ s, and after the step holds
    the composite of its aligned 2s-slab range; the monoid is not
    commutative, so each rank puts its own operand in front or behind by
    its front-to-back rank (the slab rank, flipped when sign < 0). log2(n)
    exchanges of one map tuple. Another count gathers all partials and
    folds them in front-to-back order. Differentiable: the exchange's
    backward sends the cotangent back to the peer, the gather's
    reduce-scatters."""
    if n_slab == 1:
        return maps
    packed = torch.stack(maps)
    order = slab_rank if sign > 0 else n_slab - 1 - slab_rank
    if n_slab & (n_slab - 1):
        parts = all_gather(packed[None], group)
        fold = [tuple(parts[i]) for i in range(n_slab)]
        if sign < 0:
            fold = fold[::-1]
        out = fold[0]
        for far in fold[1:]:
            out = composite_base_maps(out, far)
        return out
    out = maps
    step = 1
    while step < n_slab:
        other = tuple(exchange(torch.stack(out), slab_rank ^ step, group))
        out = (composite_base_maps(out, other) if (order & step) == 0
               else composite_base_maps(other, out))
        step *= 2
    return out


def _finish_image_sharded(maps, plan, mesh, cfg: RenderConfig,
                          medium: MediumConfig, light, lp: LocalPlan):
    """Gather the base maps over "data" and warp this rank's pixel rows
    (lp.h0:lp.h1): the band, or the whole frame when the rows do not
    divide. The gather's backward reduce-scatters the base cotangents."""
    base, miss = warp_inputs(maps, cfg)
    base = all_gather(base, mesh.get_group(DATA_AXIS))
    out = warp_base_to_pixels(base, lp.warp_plan, miss=miss)
    return replicas(postwarp_pixels(out, cfg, medium, light), lp.holders)


def sweep_render_sharded(grid, plan, mesh, cfg: RenderConfig,
                         medium: MediumConfig,
                         light: Optional[LightConfig] = None, scroll=None,
                         light_volume=None, chunk: Optional[int] = None,
                         use_kernels: Optional[bool] = None):
    """The sharded sweep_render: this rank's pixel rows (frame_rows) of
    the RGBA frame, float32 (h1 - h0, W, 4).

    grid: this rank's block of the volume split along storage z (dim 0)
    over "slab", (D / n_slab, H, W) or (D / n_slab, H, W, C), alike on
    every "data" rank; its gradient on each rank is the whole gradient of
    that block. light_volume: the whole (D, H, W) light volume, alike on
    every rank (as parallel/sweep_sharded.make_sweep_train_step builds
    it), or None. Requires n_slab | slices and n_data | base rows; the
    sweep axis's extent must divide by n_slab too when it is not z.
    Configurations as ops/sweep.sweep_render takes them, except a light
    volume of another shape than the grid's (ValueError, as in the JAX
    package). chunk and use_kernels (the JAX package's chunk and
    use_pallas) go to each rank's block as ops/sweep.sweep_render reads
    them: use_kernels=False sweeps every block with the general sweep, True
    raises NotImplementedError where no kernel covers the configuration.
    The JAX pallas_interpret (the TPU kernels' interpret mode) has no
    counterpart: a CPU block runs the kernels' plain versions."""
    n_data, data_rank, n_slab, slab_rank = mesh_ranks(mesh)
    slab_group = mesh.get_group(SLAB_AXIS)
    whole = (grid.shape[0] * n_slab, *grid.shape[1:])
    grid, scroll, light_volume = _prepare(grid, whole, medium, cfg, scroll,
                                          light_volume)
    lp = local_plan(plan, n_slab, slab_rank, n_data, data_rank)
    grid = replicated(grid, mesh.get_group(DATA_AXIS))
    perm = plan.perm + ((3,) if grid.dim() == 4 else ())
    gperm = k_block = None
    if medium.combine == "single" and whole[plan.perm[0]] == \
            plan.slice_z.shape[0]:
        # A slice per layer: only this slab's layers along the sweep axis,
        # regrouped from storage z by one all-to-all when they differ.
        k_block = grid.permute(perm)
        if plan.perm[0] != 0:
            k_block = all_to_all(k_block, slab_group, 0, 1)
    else:
        gperm = all_gather(grid, slab_group).permute(perm)
    lperm = None
    if light_volume is not None:
        lperm = replicated(light_volume, dist.group.WORLD).permute(plan.perm)
    stack, chan, lstack = _block_stacks(gperm, k_block, lperm, lp, plan, cfg,
                                        medium, scroll, slab_rank)
    maps = local_sweep(stack, chan, lstack, lp, plan, cfg, medium, light,
                       scroll, chunk, use_kernels)
    maps = _composite_slabs(maps, n_slab, plan.sign, slab_rank, slab_group)
    return _finish_image_sharded(maps, plan, mesh, cfg, medium, light, lp)


def make_sweep_train_step(mesh, plan, cfg: RenderConfig,
                          medium: MediumConfig, grid,
                          light: Optional[LightConfig] = None,
                          optimizer=None, learning_rate: float = 1e-2):
    """The sharded inverse-rendering step over the mesh: returns (step,
    optimizer). step(target) renders this rank's grid block (grid, a
    (D / n_slab, H, W) leaf made to require grad, updated in place) with
    sweep_render_sharded, takes the loss mean((rgb - target)^2) over the
    whole frame, backpropagates (K2 on each rank's block), applies the
    optimizer (torch.optim.Adam(lr=learning_rate) unless one is given,
    its moments slab-sharded with the grid), clamps the grid to [0, 1] and
    returns the loss, alike on every rank. target: this rank's rows of the
    (H, W, 3) target (frame_rows), or the whole target, which is cut.
    With shadows (light.shadow_steps > 0 and emission) the light volume is
    built each step from the gathered grid before the split, and the
    gradient runs through it too."""
    grid.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.Adam([grid], lr=learning_rate)
    use_shadow = (light is not None and light.shadow_steps > 0
                  and cfg.emission)
    h0, h1, holders = frame_rows(plan, mesh)
    H, W = plan.warp_rows01.shape
    slab_group = mesh.get_group(SLAB_AXIS)

    def step(target):
        if target.shape[0] == H and h1 - h0 != H:
            target = target[h0:h1]
        optimizer.zero_grad(set_to_none=True)
        lv = None
        if use_shadow:
            # Every rank builds the same light volume from the whole grid
            # and, through `replicated` in the sweep, backpropagates the
            # same whole cotangent into it: the gather keeps its own chunk.
            lv = light_transmittance_volume(
                gather_replicated(grid, slab_group), light, cfg, medium)
        img = sweep_render_sharded(grid, plan, mesh, cfg, medium, light,
                                   light_volume=lv)
        part = ((img[..., :3] - target) ** 2).sum() / (H * W * 3)
        part.backward()
        optimizer.step()
        with torch.no_grad():
            grid.clamp_(0.0, 1.0)
        loss = part.detach().clone()
        if dist.get_world_size() > 1:
            loss = loss.cpu() if dist.get_backend() == "gloo" else loss
            dist.all_reduce(loss)
        return float(loss) / holders

    return step, optimizer
