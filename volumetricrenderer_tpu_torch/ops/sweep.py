"""Slice-sweep renderer, forward path (port of the plan, warp and finish
parts of volumetricrenderer_tpu/ops/sweep.py).

For a pinhole camera the sample position of a ray on volume slice plane
k = z_s is affine in the ray's slope coordinates (u, v) = (w_b/w_k, w_a/w_k):

    a01 = e_a + (z_s - e_k) * v ,   b01 = e_b + (z_s - e_k) * u .

Rendering onto a regular (v, u) base grid therefore makes every slice's
resampling separable, and the volume integral becomes a front-to-back loop
over slices (kernels/sweep_fwd.py) followed by one projective warp from the
base grid to the screen pixels (warp_base_to_pixels).

The plan is built on the host in numpy, as in the JAX package, and its
arrays are placed on the requested device. Of the JAX plan's fields, only
those a GPU renderer reads are kept: the warp tile tables, bands and row,
column and scatter windows size Mosaic/XLA windows and have no counterpart
here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import LightConfig, MediumConfig, RenderConfig
from ..kernels import sweep_fwd
from .camera import Camera

__all__ = ["SweepPlan", "plan_sweep", "plan_base_dims", "base_rays",
           "sweep_render", "warp_base_to_pixels", "warp_inputs",
           "postwarp_pixels", "finish_image"]


# Grid dims are (z, y, x) = dims (0, 1, 2); coord axes are (x, y, z).
# coord c <-> grid dim (2 - c).
def _axes_for(coord_axis: int) -> Tuple[Tuple[int, int, int],
                                        Tuple[int, int, int]]:
    """Returns (perm, coord_order): perm permutes the grid so the sweep
    axis is dim 0 (the other dims keep their relative order, becoming the
    slice's rows=a and cols=b); coord_order = (c_k, c_a, c_b)."""
    gd_k = 2 - coord_axis
    rest = [d for d in range(3) if d != gd_k]
    perm = (gd_k, rest[0], rest[1])
    coord_order = (coord_axis, 2 - rest[0], 2 - rest[1])
    return perm, coord_order


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def _camera_rays_np(cam: Camera):
    """Host-side float64 per-pixel rays of a camera (the plan is built on
    the host)."""
    w, h = cam.width, cam.height
    eye, right, up, forward = (_np64(cam.eye), _np64(cam.right),
                               _np64(cam.up), _np64(cam.forward))
    tan_half = float(_np64(cam.tan_half_fov))
    xs = (np.arange(w, dtype=np.float64) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (np.arange(h, dtype=np.float64) + 0.5) / h * 2.0
    px, py = np.meshgrid(xs, ys, indexing="xy")
    dirs = (px[..., None] * (right * tan_half * cam.aspect)
            + py[..., None] * (up * tan_half) + forward)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(eye, dirs.shape)
    return origins, dirs


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Geometry of one sweep: dominant axis, base grid, slice set and the
    screen-warp coordinates. Arrays are float32 on the render device."""

    eye01: torch.Tensor       # (3,) eye in normalized coords, (k, a, b) order
    v_grid: torch.Tensor      # (Hb,) slope along a per base row
    u_grid: torch.Tensor      # (Wb,) slope along b per base col
    slice_z: torch.Tensor     # (S,) normalized slice positions, front to back
    seglen: torch.Tensor      # (Hb, Wb) world path length per slice step
    warp_rows01: torch.Tensor  # (H, W) pixel -> base-grid row coords
    warp_cols01: torch.Tensor  # (H, W) pixel -> base-grid col coords
    box_range: torch.Tensor   # (3,) world box extent, (k, a, b) order
    box_min: torch.Tensor     # (3,) world box min, (k, a, b) order
    axis: int                 # sweep coord axis
    sign: int                 # ray direction along the axis
    perm: Tuple[int, int, int]
    coord_order: Tuple[int, int, int]
    identity_warp: bool = False

    @property
    def base_shape(self):
        return (self.v_grid.shape[0], self.u_grid.shape[0])


def _host_geometry(
    camera: Camera,
    grid_shape: Tuple[int, ...],
    cfg: RenderConfig,
    world_to_local=None,
    supersample: float = 1.5,
    n_slices: Optional[int] = None,
    max_base_dim: int = 3072,
    min_axis_component: float = 0.05,
    force_base_dims: Optional[Tuple[int, int]] = None,
):
    """Host-side (numpy) sweep geometry shared by plan_sweep and
    plan_base_dims: axis choice, base-grid axes, slice set."""
    o, d = _camera_rays_np(camera)
    if world_to_local is not None:
        m = _np64(world_to_local)
        o = o @ m[:3, :3].T + m[:3, 3]
        d = d @ m[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    box_min = np.asarray(cfg.box_min, np.float64)
    box_range = np.asarray(cfg.box_max, np.float64) - box_min
    e01_xyz = (np.asarray(o.reshape(-1, 3)[0]) - box_min) / box_range
    w = d / box_range  # direction in normalized coords (unnormalized length)

    # Dominant axis: maximize the minimum |w_c| over all pixels.
    min_abs = np.abs(w).reshape(-1, 3).min(axis=0)
    axis = int(np.argmax(min_abs))
    if min_abs[axis] < min_axis_component:
        raise ValueError(
            f"sweep unsupported: min |w_axis| = {min_abs[axis]:.4f} < "
            f"{min_axis_component} (rays near-parallel to every axis plane)")
    wk = w[..., axis]
    sgn = np.sign(wk.reshape(-1)[0])
    if not np.all(np.sign(wk) == sgn):
        raise ValueError("sweep unsupported: mixed ray direction signs "
                         "along the dominant axis")
    sign = int(sgn)

    perm, coord_order = _axes_for(axis)
    c_k, c_a, c_b = coord_order
    u = w[..., c_b] / wk  # (H, W)
    v = w[..., c_a] / wk

    # Slices at voxel layer centers of the permuted grid by default.
    depth = grid_shape[perm[0]]
    S = int(n_slices) if n_slices is not None else int(depth)
    z01 = (np.arange(S) + 0.5) / S
    slice_z = z01 if sign > 0 else z01[::-1]  # front-to-back

    deltas = z01 - e01_xyz[c_k]
    front = deltas * sign > 0
    delta_near = deltas[front][np.argmin(np.abs(deltas[front]))] \
        if front.any() else None

    # Base grid per transverse axis: the pixel slope range clipped to the
    # box's slope footprint, spaced uniformly in atan(slope).
    def base_axis(q, e_t, n_force=None):
        th = np.arctan(q)
        lo, hi = float(q.min()), float(q.max())
        if delta_near is not None and abs(delta_near) > 0.02:
            cand = [(b - e_t) / dd for b in (0.0, 1.0)
                    for dd in (delta_near, float(deltas[front].max()
                                                 if sign > 0 else
                                                 deltas[front].min()))]
            lo = max(lo, min(cand))
            hi = min(hi, max(cand))
            if not lo < hi:  # camera never sees the box on this axis
                lo, hi = float(q.min()), float(q.max())
        th_lo, th_hi = math.atan(lo), math.atan(hi)
        # Pixel angular spacing: per-direction medians, keep the larger.
        meds = []
        for ax in (0, 1):
            if th.shape[ax] > 1:
                d1 = np.abs(np.diff(th, axis=ax)).reshape(-1)
                d1 = d1[d1 > 1e-12]
                if d1.size:
                    meds.append(float(np.median(d1)))
        spacing = max(meds) if meds else 0.0
        if not spacing or not np.isfinite(spacing):
            spacing = max(th_hi - th_lo, 1e-6) / 64
        if n_force is not None:
            n = int(n_force)
        else:
            n = int(math.ceil((th_hi - th_lo) / spacing * supersample)) + 2
            n = max(128, min(_round_up(n, 128), max_base_dim))
        pad = (th_hi - th_lo) / n
        th_lo, th_hi = th_lo - pad, th_hi + pad
        centers = th_lo + (np.arange(n) + 0.5) / n * (th_hi - th_lo)
        return np.tan(centers), th_lo, th_hi, n

    fh, fw = force_base_dims if force_base_dims is not None else (None, None)
    u_grid, thu_lo, thu_hi, Wb = base_axis(u, e01_xyz[c_b], fw)
    v_grid, thv_lo, thv_hi, Hb = base_axis(v, e01_xyz[c_a], fh)

    rng_perm = box_range[[c_k, c_a, c_b]]
    return dict(axis=axis, sign=sign, perm=perm, coord_order=coord_order,
                e01_xyz=e01_xyz, u_grid=u_grid, v_grid=v_grid,
                thu_lo=thu_lo, thu_hi=thu_hi, thv_lo=thv_lo, thv_hi=thv_hi,
                Hb=Hb, Wb=Wb, slice_z=slice_z, S=S, box_min=box_min,
                box_range=box_range, rng_perm=rng_perm)


def plan_base_dims(camera: Camera, grid_shape, cfg: RenderConfig,
                   world_to_local=None, supersample: float = 1.5,
                   max_base_dim: int = 3072):
    """Cheap host-only probe of a camera's base-grid dims: returns
    (Hb, Wb, axis, sign). An animation probes every frame and passes the
    maximum back through plan_sweep's force_base_dims."""
    g = _host_geometry(camera, grid_shape, cfg, world_to_local, supersample,
                       None, max_base_dim)
    return g["Hb"], g["Wb"], g["axis"], g["sign"]


def plan_sweep(
    camera: Camera,
    grid_shape: Tuple[int, ...],
    cfg: RenderConfig,
    world_to_local=None,
    supersample: float = 1.5,
    n_slices: Optional[int] = None,
    max_base_dim: int = 3072,
    min_axis_component: float = 0.05,
    force_base_dims: Optional[Tuple[int, int]] = None,
    device=None,
) -> SweepPlan:
    """Build the sweep geometry for a concrete camera.

    The sweep axis is the coordinate axis along which every pixel ray has
    the largest guaranteed direction component; raises ValueError when no
    axis qualifies. The host geometry is float64 numpy; like the JAX plan,
    every array is rounded to float32 first and the per-pixel maps (seglen,
    warp coords) are computed in float32 on `device`."""
    g = _host_geometry(camera, grid_shape, cfg, world_to_local, supersample,
                       n_slices, max_base_dim, min_axis_component,
                       force_base_dims)
    c_k, c_a, c_b = g["coord_order"]
    S = g["S"]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    right, up, forward = (f32(_np64(camera.right)), f32(_np64(camera.up)),
                          f32(_np64(camera.forward)))
    tan_half = f32(_np64(camera.tan_half_fov))
    rng_perm = f32(g["rng_perm"])
    eye01 = f32(g["e01_xyz"][[c_k, c_a, c_b]])
    box_min = f32(g["box_min"][[c_k, c_a, c_b]])
    v_grid, u_grid = f32(g["v_grid"]), f32(g["u_grid"])
    slice_z = f32(np.ascontiguousarray(g["slice_z"]))
    thu_lo, thu_hi, thv_lo, thv_hi = (f32(g[k]) for k in
                                      ("thu_lo", "thu_hi", "thv_lo", "thv_hi"))

    seglen = (1.0 / S) * torch.sqrt(
        rng_perm[0] ** 2
        + (v_grid[:, None] * rng_perm[1]) ** 2
        + (u_grid[None, :] * rng_perm[2]) ** 2)

    width, height = camera.width, camera.height
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=device)
                + 0.5) / height * 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    dirs = (px[..., None] * (right * tan_half * float(camera.aspect))
            + py[..., None] * (up * tan_half) + forward)
    if world_to_local is not None:
        w2l = f32(_np64(world_to_local))
        dirs = dirs @ w2l[:3, :3].T  # slopes are scale-invariant
    w = dirs / f32(g["box_range"])
    u = w[..., c_b] / w[..., c_k]
    v = w[..., c_a] / w[..., c_k]
    rows01 = (torch.atan(v) - thv_lo) / (thv_hi - thv_lo)
    cols01 = (torch.atan(u) - thu_lo) / (thu_hi - thu_lo)

    return SweepPlan(eye01=eye01, v_grid=v_grid, u_grid=u_grid,
                     slice_z=slice_z, seglen=seglen, warp_rows01=rows01,
                     warp_cols01=cols01, box_range=rng_perm, box_min=box_min,
                     axis=g["axis"], sign=g["sign"], perm=g["perm"],
                     coord_order=g["coord_order"])


def _to_xyz(perm_vec, coord_order):
    """Reorder the last axis from the plan's (k, a, b) order to (x, y, z)."""
    inv = [coord_order.index(c) for c in range(3)]
    return perm_vec[..., inv]


def base_rays(plan: SweepPlan):
    """World-space rays of the base grid (for oracle cross-checks): one ray
    per (v_i, u_j) base pixel, through the camera eye. Returns (origins,
    directions), each (Hb, Wb, 3), on the plan's device."""
    Hb, Wb = plan.base_shape
    sign = float(plan.sign)
    w_perm = torch.stack(
        [torch.full((Hb, Wb), sign, dtype=torch.float32,
                    device=plan.v_grid.device),
         sign * plan.v_grid[:, None].expand(Hb, Wb),
         sign * plan.u_grid[None, :].expand(Hb, Wb)], dim=-1)
    d = _to_xyz(w_perm, plan.coord_order) \
        * _to_xyz(plan.box_range, plan.coord_order)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = (_to_xyz(plan.box_min, plan.coord_order)
         + _to_xyz(plan.eye01, plan.coord_order)
         * _to_xyz(plan.box_range, plan.coord_order))
    return o.expand(d.shape), d


def _in01(x):
    return (x >= 0.0) & (x <= 1.0)


def _taps(q01, n):
    """Clip-then-tent bilinear taps along one base axis: the position
    clips to [0, n-1] texel units first, so an out-of-range position
    takes the edge texel with weight 1 (the JAX warp's _tap_weights)."""
    p = torch.clamp(q01 * n - 0.5, 0.0, float(n - 1))
    i0f = torch.floor(p)
    i0 = i0f.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n - 1), (p - i0f)[..., None]


def warp_base_to_pixels(base_img, plan: SweepPlan, miss=None):
    """Resample base-grid maps (Hb, Wb[, C]) to the camera pixels
    (H, W[, C]) as a per-pixel 4-tap bilinear gather.

    Pixels mapping outside the base grid's [0, 1] footprint are guaranteed
    box misses: they take the per-channel `miss` value."""
    if plan.identity_warp:
        return base_img
    squeeze = base_img.dim() == 2
    if squeeze:
        base_img = base_img[..., None]
    Hb, Wb = base_img.shape[:2]
    r0, r1, fr = _taps(plan.warp_rows01, Hb)
    c0, c1, fc = _taps(plan.warp_cols01, Wb)
    out = ((1.0 - fc) * ((1.0 - fr) * base_img[r0, c0] + fr * base_img[r1, c0])
           + fc * ((1.0 - fr) * base_img[r0, c1] + fr * base_img[r1, c1]))
    if miss is not None:
        inr = (_in01(plan.warp_rows01) & _in01(plan.warp_cols01))[..., None]
        out = torch.where(inr, out, torch.as_tensor(miss, dtype=out.dtype,
                                                    device=out.device))
    return out[..., 0] if squeeze else out


def warp_inputs(base_maps, cfg: RenderConfig):
    """The two scalar maps the warp transports, and their miss values."""
    acc, trans, wsum, hit = base_maps
    if cfg.emission:
        return torch.stack([wsum, trans], dim=-1), (0.0, 1.0)
    return torch.stack([acc, hit], dim=-1), (0.0, 0.0)


def postwarp_pixels(out, cfg: RenderConfig, medium: MediumConfig,
                    light: Optional[LightConfig] = None):
    """Per-pixel nonlinearities after the warp: color = wsum * light color,
    or the Beer-Lambert display transform in absorption mode."""
    background = torch.tensor(cfg.background, dtype=torch.float32,
                              device=out.device)
    if cfg.emission:
        lt = light if light is not None else LightConfig()
        lcol = torch.tensor(lt.color, dtype=torch.float32, device=out.device)
        rgb = out[..., 0:1] * lcol + out[..., 1:2] * background
        alpha = 1.0 - out[..., 1]
    else:
        gray = 1.0 - torch.exp(-medium.density * out[..., 0])
        hitp = torch.clamp(out[..., 1], 0.0, 1.0)
        rgb = (gray[..., None] * hitp[..., None]
               + background * (1.0 - hitp[..., None]))
        alpha = hitp
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def finish_image(base_maps, plan: SweepPlan, cfg: RenderConfig,
                 medium: MediumConfig, light: Optional[LightConfig] = None):
    """Warp the linear base quantities to screen pixels, then apply the
    per-pixel nonlinearities (the warp commutes with linear post-ops only).
    Returns the (H, W, 4) RGBA image."""
    base, miss = warp_inputs(base_maps, cfg)
    out = warp_base_to_pixels(base, plan, miss=miss)
    return postwarp_pixels(out, cfg, medium, light)


def sweep_render(grid, plan: SweepPlan, cfg: RenderConfig,
                 medium: MediumConfig, light: Optional[LightConfig] = None,
                 scroll=None, light_volume=None):
    """Render one RGBA frame (H, W, 4) from a (D, H, W) float32 density
    grid by sweeping slices front to back.

    A CUDA grid goes through the hand-written sweep kernel, a CPU grid
    through its plain PyTorch version (kernels/sweep_fwd.sweep_base).
    Configurations the kernel does not cover raise NotImplementedError:
    the JAX package's general jnp sweep (4-channel combine, scroll, light
    volume) is not ported yet."""
    if not sweep_fwd.supported(cfg, medium, light_volume, scroll,
                               grid.dim()):
        raise NotImplementedError(
            "the torch sweep covers combine='single', float32, a 3-D grid, "
            "no scroll, no light volume and mirror/clamp/wrap addressing; "
            f"got combine={medium.combine!r}, dtype={cfg.dtype!r}, "
            f"grid.dim()={grid.dim()}, scroll={scroll is not None}, "
            f"light_volume={light_volume is not None}, "
            f"address_mode={cfg.address_mode!r}")
    base_maps = sweep_fwd.sweep_base(grid.permute(plan.perm), plan, cfg,
                                     medium, light)
    return finish_image(base_maps, plan, cfg, medium, light=light)
