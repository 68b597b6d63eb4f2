"""Slice-sweep renderer, forward path (port of the plan, warp and finish
parts of volumetricrenderer_tpu/ops/sweep.py).

For a pinhole camera the sample position of a ray on volume slice plane
k = z_s is affine in the ray's slope coordinates (u, v) = (w_b/w_k, w_a/w_k):

    a01 = e_a + (z_s - e_k) * v ,   b01 = e_b + (z_s - e_k) * u .

Rendering onto a regular (v, u) base grid therefore makes every slice's
resampling separable, and the volume integral becomes a front-to-back loop
over slices (kernels/sweep_fwd.py) followed by one projective warp from the
base grid to the screen pixels (warp_base_to_pixels). The 4-channel
reference medium sweeps the same way (kernels/sweep_ref_fwd.py); a frame
of it that repeats a grid and plan replays CUDA graphs of its layers,
sweep and warp (_RefFrameGraphs), and under autograd without a scroll of
their backwards too (_RefStepGraphs: a fit's step). What no
kernel covers (the reference medium with clamp or wrap addressing, a light
volume of another shape than the grid's) takes the general sweep
(_sweep_base), plain PyTorch like the JAX package's jnp sweep; the
compositing monoid composite_base_maps joins the base maps of consecutive
slice ranges (parallel/sweep_sharded.py).

The plan's geometry is the JAX package's float64 arithmetic, run in torch
on the requested device: the per-pixel rays, slopes and spacing medians on
the device, the few scalars they reduce to (axis, sign, slope range, base
dims, slice set) on the host; its arrays are float32 on that device. Of
the JAX plan's fields, only those a GPU renderer reads are kept: the warp
tile tables, bands and row, column and scatter windows size Mosaic/XLA
windows and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..config import LightConfig, MediumConfig, RenderConfig
from ..kernels import sweep_fwd, sweep_ref_bwd, sweep_ref_fwd, warp_bilinear
from ..kernels.build import IdentityCache, bf16_round
from ..kernels.warp_bilinear import in01 as _in01
from ..utils import clock
from ..utils.metrics import get_logger
from .camera import Camera
from .resample import linear_resample_matrix
from .sampling import apply_address_mode, clip_unit

__all__ = ["SweepPlan", "plan_sweep", "plan_base_dims", "base_rays",
           "sweep_render", "warp_base_to_pixels", "warp_inputs",
           "postwarp_pixels", "finish_image", "composite_base_maps"]


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


def _unit(v):
    """Components (x, y, z) of vectors scaled to unit length, the squares
    summed in np.linalg.norm's order."""
    n = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return [c / n for c in v]


def _camera_dirs(cam: Camera, device):
    """Float64 unit ray directions of a camera's pixels on `device`, as
    three (H, W) components (x, y, z): pixel centers, row 0 at the top, the
    JAX package's host arithmetic in its order."""
    w, h = cam.width, cam.height
    right, up, forward = _np64(cam.right), _np64(cam.up), _np64(cam.forward)
    tan_half = float(_np64(cam.tan_half_fov))
    along_x, along_y = right * tan_half * cam.aspect, up * tan_half
    xs = (torch.arange(w, dtype=torch.float64, device=device) + 0.5) \
        / w * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float64, device=device)
                + 0.5) / h * 2.0
    return _unit([xs[None, :] * float(along_x[c])
                  + ys[:, None] * float(along_y[c]) + float(forward[c])
                  for c in range(3)])


def _np_median(x):
    """np.median of x's values other than NaN, a 0-d tensor on x's device
    (NaN where there are none): the mean of the two middle values of an
    even count. nanmedian gives the lower; the upper is the least value
    above it, or the lower itself where its ties reach past the middle."""
    lo = x.nanmedian()
    ties_past_middle = (x <= lo).sum() > (~x.isnan()).sum() // 2
    hi = torch.where(ties_past_middle, lo,
                     torch.where(x > lo, x, math.inf).amin())
    return (lo + hi) / 2


def _slope_stats(q):
    """0-d float64 tensors on q's device: the min and max of a (H, W) slope
    map, then for each direction with two or more pixels (rows, columns)
    the median of |diff(atan q)| over its values above 1e-12, NaN where
    none is left."""
    th = torch.atan(q)
    out = [q.min(), q.max()]
    for ax in (0, 1):
        if q.shape[ax] > 1:
            d1 = torch.diff(th, dim=ax).abs()
            out.append(_np_median(torch.where(d1 > 1e-12, d1, math.nan)))
    return out


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


device_geometry_calls = 0  # _host_geometry calls on a CUDA device


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
    device=None,
):
    """Sweep geometry shared by plan_sweep and plan_base_dims: axis choice,
    base-grid axes, slice set, in the JAX package's float64 arithmetic and
    order. The per-pixel part (rays, slopes, the medians of their angular
    spacing) runs in float64 torch on `device` (the CPU for None), and the
    host reads its scalars back in two transfers; the slice set and the
    base dims are host arithmetic. The base-grid slopes are float64 on
    `device`. A call on a CUDA device adds one to the module's
    `device_geometry_calls`."""
    global device_geometry_calls
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        device_geometry_calls += 1
    d = _camera_dirs(camera, device)
    eye = _np64(camera.eye)
    if world_to_local is not None:
        m = _np64(world_to_local)
        eye = eye @ m[:3, :3].T + m[:3, 3]
        d = _unit([d[0] * float(m[r, 0]) + d[1] * float(m[r, 1])
                   + d[2] * float(m[r, 2]) for r in range(3)])
    box_min = np.asarray(cfg.box_min, np.float64)
    box_range = np.asarray(cfg.box_max, np.float64) - box_min
    e01_xyz = (eye - box_min) / box_range
    # direction in normalized coords (unnormalized length)
    w = [d[c] / float(box_range[c]) for c in range(3)]

    # Dominant axis: maximize the minimum |w_c| over all pixels; every ray
    # must share the first pixel's direction sign along it.
    first = [wc.reshape(-1)[0].sign() for wc in w]
    probe = torch.stack(
        [wc.abs().min() for wc in w] + first
        + [(wc.sign() != s).any().to(torch.float64)
           for wc, s in zip(w, first)]).tolist()
    min_abs, first_sign, mixed = probe[:3], probe[3:6], probe[6:]
    axis = int(np.argmax(min_abs))
    if min_abs[axis] < min_axis_component:
        raise ValueError(
            f"sweep unsupported: min |w_axis| = {min_abs[axis]:.4f} < "
            f"{min_axis_component} (rays near-parallel to every axis plane)")
    if mixed[axis]:
        raise ValueError("sweep unsupported: mixed ray direction signs "
                         "along the dominant axis")
    sign = int(first_sign[axis])

    perm, coord_order = _axes_for(axis)
    c_k, c_a, c_b = coord_order
    u_stats = _slope_stats(w[c_b] / w[c_k])  # of the (H, W) slopes u, v
    v_stats = _slope_stats(w[c_a] / w[c_k])
    stats = torch.stack(u_stats + v_stats).tolist()
    u_stats, v_stats = stats[:len(u_stats)], stats[len(u_stats):]

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
    def base_axis(q_stats, e_t, n_force=None):
        q_min, q_max, *meds = q_stats
        lo, hi = q_min, q_max
        if delta_near is not None and abs(delta_near) > 0.02:
            cand = [(b - e_t) / dd for b in (0.0, 1.0)
                    for dd in (delta_near, float(deltas[front].max()
                                                 if sign > 0 else
                                                 deltas[front].min()))]
            lo = max(lo, min(cand))
            hi = min(hi, max(cand))
            if not lo < hi:  # camera never sees the box on this axis
                lo, hi = q_min, q_max
        th_lo, th_hi = math.atan(lo), math.atan(hi)
        # Pixel angular spacing: per-direction medians, keep the larger.
        meds = [m for m in meds if not math.isnan(m)]
        spacing = max(meds) if meds else 0.0
        if not spacing or not math.isfinite(spacing):
            spacing = max(th_hi - th_lo, 1e-6) / 64
        if n_force is not None:
            n = int(n_force)
        else:
            n = int(math.ceil((th_hi - th_lo) / spacing * supersample)) + 2
            n = max(128, min(_round_up(n, 128), max_base_dim))
        pad = (th_hi - th_lo) / n
        th_lo, th_hi = th_lo - pad, th_hi + pad
        centers = th_lo + (torch.arange(n, dtype=torch.float64, device=device)
                           + 0.5) / n * (th_hi - th_lo)
        return torch.tan(centers), th_lo, th_hi, n

    fh, fw = force_base_dims if force_base_dims is not None else (None, None)
    u_grid, thu_lo, thu_hi, Wb = base_axis(u_stats, e01_xyz[c_b], fw)
    v_grid, thv_lo, thv_hi, Hb = base_axis(v_stats, e01_xyz[c_a], fh)

    rng_perm = box_range[[c_k, c_a, c_b]]
    return dict(axis=axis, sign=sign, perm=perm, coord_order=coord_order,
                e01_xyz=e01_xyz, u_grid=u_grid, v_grid=v_grid,
                thu_lo=thu_lo, thu_hi=thu_hi, thv_lo=thv_lo, thv_hi=thv_hi,
                Hb=Hb, Wb=Wb, slice_z=slice_z, S=S, box_min=box_min,
                box_range=box_range, rng_perm=rng_perm)


def plan_base_dims(camera: Camera, grid_shape, cfg: RenderConfig,
                   world_to_local=None, supersample: float = 1.5,
                   max_base_dim: int = 3072, device=None):
    """Cheap probe of a camera's base-grid dims: returns (Hb, Wb, axis,
    sign). Its per-pixel geometry runs on `device`, the CPU for None. An
    animation probes every frame and passes the maximum back through
    plan_sweep's force_base_dims."""
    g = _host_geometry(camera, grid_shape, cfg, world_to_local, supersample,
                       None, max_base_dim, device=device)
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
    axis qualifies. The geometry (_host_geometry) is float64, its per-pixel
    part on `device`; like the JAX plan, every array is rounded to float32
    first (the base-grid slopes on `device`, the host's vectors before
    their one copy to it) and the per-pixel maps (seglen, warp coords) are
    computed in float32 on `device`. Spans: "plan.build" around it all,
    "plan.geometry" around the geometry; the rest is the copy and the
    per-pixel maps."""
    with clock.span("plan.build"):
        with clock.span("plan.geometry"):
            g = _host_geometry(camera, grid_shape, cfg, world_to_local,
                               supersample, n_slices, max_base_dim,
                               min_axis_component, force_base_dims, device)
        c_k, c_a, c_b = g["coord_order"]
        S = g["S"]
        host = [_np64(camera.right), _np64(camera.up), _np64(camera.forward),
                _np64(camera.tan_half_fov).reshape(1), g["rng_perm"],
                g["e01_xyz"][[c_k, c_a, c_b]], g["box_min"][[c_k, c_a, c_b]],
                g["slice_z"], [g["thu_lo"], g["thu_hi"], g["thv_lo"],
                               g["thv_hi"]], g["box_range"]]
        if world_to_local is not None:
            host.append(_np64(world_to_local)[:3, :3].T)
        host = [np.asarray(x, np.float32).reshape(-1) for x in host]
        (right, up, forward, tan_half, rng_perm, eye01, box_min, slice_z,
         (thu_lo, thu_hi, thv_lo, thv_hi), box_range, *w2l_t) = \
            torch.as_tensor(np.concatenate(host), device=device).split(
                [x.size for x in host])
        v_grid, u_grid = g["v_grid"].float(), g["u_grid"].float()

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
        if w2l_t:  # world_to_local's rotation, transposed
            dirs = dirs @ w2l_t[0].reshape(3, 3)  # slopes: scale-invariant
        w = dirs / box_range
        u = w[..., c_b] / w[..., c_k]
        v = w[..., c_a] / w[..., c_k]
        rows01 = (torch.atan(v) - thv_lo) / (thv_hi - thv_lo)
        cols01 = (torch.atan(u) - thu_lo) / (thu_hi - thu_lo)

        return SweepPlan(eye01=eye01, v_grid=v_grid, u_grid=u_grid,
                         slice_z=slice_z, seglen=seglen, warp_rows01=rows01,
                         warp_cols01=cols01, box_range=rng_perm,
                         box_min=box_min, axis=g["axis"], sign=g["sign"],
                         perm=g["perm"], coord_order=g["coord_order"])


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


@functools.lru_cache(maxsize=64)
def _device_const(values, dtype, device):
    """A tensor of `values` on `device`, made once: a constant made in every
    frame would be a copy from pageable host memory, which waits for the
    device's queue to drain."""
    return torch.tensor(values, dtype=dtype, device=device)


class _WarpBilinear(torch.autograd.Function):
    """The bilinear warp base (Hb, Wb, C) -> (H, W, C) at the per-pixel
    base coordinates (rows01, cols01), with the miss select and its
    adjoint written out: the port of the JAX package's custom VJP
    (_warp_bilinear, its _warp_bilinear_fwd and _warp_bilinear_bwd, the
    splat _splat_windowed; warp_band for one band of pixel rows in the
    sharded path, which here is the same op on a row-sliced plan) and of
    the where around it. Autograd of the gather would splat with
    index_put_ and accumulate, a sort-based scatter.

    Forward: the 4-tap gather of clip-then-tent taps (kernels/
    warp_bilinear.py taps); with `miss` (C floats, or None), out-of-
    footprint pixels take it. Saved: the base's shape and the two
    coordinate maps, as in JAX; the backward recomputes the taps.
    Backward: the pixel cotangents splatted into the base with the same
    four weights (atomics on CUDA, so the last bits of a texel's sum
    follow the order its adds land in); with `miss`, out-of-footprint
    pixels have a zero cotangent and add nothing; zero for the
    coordinates. Reverse mode only, as a jax.custom_vjp. On a CUDA base
    each way is one kernel (kernels/warp_bilinear.py), which refuses what
    it cannot take (a base or maps not float32, more than 4 channels); on
    a CPU base, its plain version. The backward is the span "warp.splat",
    with its device interval."""

    @staticmethod
    def forward(ctx, base, rows01, cols01, miss):
        ctx.save_for_backward(rows01, cols01)
        ctx.base_shape, ctx.masked = base.shape, miss is not None
        ctx.kernel = base.device.type != "cpu"
        if ctx.kernel:
            return warp_bilinear.launch_forward(base, rows01, cols01, miss)
        return warp_bilinear.warp_reference(
            base, rows01, cols01,
            None if miss is None else _device_const(miss, base.dtype,
                                                    base.device))

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        with clock.span("warp.splat", device=ct):
            rows01, cols01 = ctx.saved_tensors
            splat = (warp_bilinear.launch_backward if ctx.kernel
                     else warp_bilinear.splat_reference)
            return (splat(ct, rows01, cols01, ctx.base_shape, ctx.masked),
                    None, None, None)


def warp_base_to_pixels(base_img, plan: SweepPlan, miss=None):
    """Resample base-grid maps (Hb, Wb[, C]) to the camera pixels
    (H, W[, C]) as a per-pixel 4-tap bilinear gather (_WarpBilinear, whose
    backward is the explicit 4-tap splat).

    Pixels mapping outside the base grid's [0, 1] footprint are guaranteed
    box misses: they take the `miss` value, a scalar or one per channel."""
    if plan.identity_warp:
        return base_img
    squeeze = base_img.dim() == 2
    if squeeze:
        base_img = base_img[..., None]
    if miss is not None:
        miss = ((float(miss),) if isinstance(miss, (int, float))
                else tuple(float(m) for m in miss))
        if len(miss) == 1:
            miss *= base_img.shape[-1]
        if len(miss) != base_img.shape[-1]:
            raise ValueError(f"warp_base_to_pixels: miss holds {len(miss)} "
                             f"values for {base_img.shape[-1]} channels")
    out = _WarpBilinear.apply(base_img, plan.warp_rows01, plan.warp_cols01,
                              miss)
    return out[..., 0] if squeeze else out


def warp_inputs(base_maps, cfg: RenderConfig):
    """The two scalar maps the warp transports, and their miss values."""
    acc, trans, wsum, hit = base_maps
    if cfg.emission:
        return torch.stack([wsum, trans], dim=-1), (0.0, 1.0)
    return torch.stack([acc, hit], dim=-1), (0.0, 0.0)


def _beer_lambert(out, density, background):
    """Absorption's display transform of the warped (acc, hit) pixels:
    gray = 1 - exp(-density * acc), hitp = clamp(hit, 0, 1), rgb = gray *
    hitp + background * (1 - hitp), alpha = hitp. Returns the (H, W, 4)
    pixels and (exp(-density * acc), gray, hitp)."""
    e = torch.exp(-density * out[..., 0])
    gray = 1.0 - e
    hitp = torch.clamp(out[..., 1], 0.0, 1.0)
    rgb = (gray[..., None] * hitp[..., None]
           + background * (1.0 - hitp[..., None]))
    return torch.cat([rgb, hitp[..., None]], dim=-1), (e, gray, hitp)


class _BeerLambert(torch.autograd.Function):
    """_beer_lambert as one autograd node, differentiable in the warped
    pixels: the forward is its arithmetic; the backward writes out the
    adjoint, d acc = sum_c(d rgb_c) * hitp * density * e and d hit =
    sum_c(d rgb_c * (gray - background_c)) + d alpha where 0 <= hit <= 1
    (clamp's own rule), in a dozen operations where autograd takes about
    two dozen."""

    @staticmethod
    def forward(ctx, out, density, background):
        pixels, (e, gray, hitp) = _beer_lambert(out, density, background)
        ctx.save_for_backward(out, e, gray, hitp, background)
        ctx.density = density
        return pixels

    @staticmethod
    @once_differentiable
    def backward(ctx, dpix):
        out, e, gray, hitp, background = ctx.saved_tensors
        drgb = dpix[..., :3]
        total = drgb.sum(-1)
        d_acc = total * hitp * e * ctx.density
        d_hitp = total * gray - (drgb * background).sum(-1) + dpix[..., 3]
        d_hit = torch.where(hitp == out[..., 1], d_hitp, 0.0)
        return torch.stack([d_acc, d_hit], dim=-1), None, None


def postwarp_pixels(out, cfg: RenderConfig, medium: MediumConfig,
                    light: Optional[LightConfig] = None):
    """Per-pixel nonlinearities after the warp: color = wsum * light color,
    or the Beer-Lambert display transform in absorption mode (under
    autograd the node _BeerLambert)."""
    background = _device_const(tuple(cfg.background), torch.float32,
                               out.device)
    if not cfg.emission:
        if torch.is_grad_enabled() and out.requires_grad:
            return _BeerLambert.apply(out, medium.density, background)
        return _beer_lambert(out, medium.density, background)[0]
    lt = light if light is not None else LightConfig()
    lcol = _device_const(tuple(lt.color), torch.float32, out.device)
    rgb = out[..., 0:1] * lcol + out[..., 1:2] * background
    alpha = 1.0 - out[..., 1]
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def finish_image(base_maps, plan: SweepPlan, cfg: RenderConfig,
                 medium: MediumConfig, light: Optional[LightConfig] = None):
    """Warp the linear base quantities to screen pixels, then apply the
    per-pixel nonlinearities (the warp commutes with linear post-ops only).
    Returns the (H, W, 4) RGBA image. Span "warp.fwd", with its device
    interval."""
    with clock.span("warp.fwd", device=base_maps[0]):
        base, miss = warp_inputs(base_maps, cfg)
        out = warp_base_to_pixels(base, plan, miss=miss)
        return postwarp_pixels(out, cfg, medium, light)


def _layer_lerp(gperm, qk, depth, address_mode):
    """The two layers of gperm (D, A, B[, C]) bracketing the normalized
    sweep coordinate qk (a 0-dim tensor), lerped."""
    p = qk * depth - 0.5
    i0f = torch.floor(p)
    f = p - i0f
    i0 = i0f.to(torch.int64)
    l0 = apply_address_mode(i0, depth, address_mode)
    l1 = apply_address_mode(i0 + 1, depth, address_mode)
    g0 = torch.index_select(gperm, 0, l0.reshape(1))[0]
    g1 = torch.index_select(gperm, 0, l1.reshape(1))[0]
    return g0 + f * (g1 - g0)


def _resample_slice(g2d, a01, b01, address_mode, low):
    """Wa @ g2d @ Wb^T with the banded matrices of ops/resample.py. The
    matrices are plan geometry, never differentiated. low (the bfloat16
    mode, as the JAX package's jnp sweep takes it): the matrices, the slab
    and the product between the two matmuls rounded to bfloat16, products
    summed in float32."""
    A, B = g2d.shape
    Wa = linear_resample_matrix(a01.detach(), A, address_mode)
    Wb = linear_resample_matrix(b01.detach(), B, address_mode)
    g2d = g2d.to(torch.float32)
    if low:
        Wa, Wb, g2d = bf16_round(Wa), bf16_round(Wb), bf16_round(g2d)
    t = Wa @ g2d
    if low:
        t = bf16_round(t)
    return t @ Wb.T


def _combine_reference_inplane(channel_slab, a01, b01, medium, offs,
                               address_mode, low):
    """The reference combine's in-plane half: per channel, the separable
    resample of its (already sweep-axis lerped) 2-D slab channel_slab(c) at
    its scaled and scrolled coordinates, then (s1*s2)*(s3+s4)*scale.
    offs: sweep_ref_fwd._channel_offsets' (k, a, b) offsets per channel."""
    samples = []
    for c in range(4):
        sc = medium.channel_coord_scale[c]
        _, off_a, off_b = offs[c]
        samples.append(_resample_slice(channel_slab(c), a01 * sc + off_a,
                                       b01 * sc + off_b, address_mode, low))
    s1, s2, s3, s4 = samples
    return (s1 * s2) * (s3 + s4) * medium.sample_scale


def _sigma_general(gperm, z_s, a01, b01, medium, offs, address_mode, low):
    """Per-slice extinction (Hb, Wb) for either combine mode, any coordinate
    scale and scroll: ops/integrate.sample_sigma with the trilinear sample
    split into the sweep-axis layer lerp and the separable in-plane
    resample."""
    depth = gperm.shape[0]
    if medium.combine == "reference":
        def lerped_channel(c):
            sc = medium.channel_coord_scale[c]
            return _layer_lerp(gperm[..., c], z_s * sc + offs[c][0], depth,
                               address_mode)
        return _combine_reference_inplane(lerped_channel, a01, b01, medium,
                                          offs, address_mode, low)
    if medium.combine == "single":
        g = gperm[..., 0] if gperm.dim() == 4 else gperm
        g = _layer_lerp(g, z_s, depth, address_mode)
        return _resample_slice(g, a01, b01, address_mode, low) \
            * medium.sample_scale
    raise ValueError(f"unknown combine mode {medium.combine!r}")


general_calls = 0  # _sweep_base calls since import (or since a reset)


def _sweep_base(gperm, lperm, slice_z, v_grid, u_grid, seglen,
                plan: SweepPlan, cfg: RenderConfig, medium: MediumConfig,
                light: Optional[LightConfig], scroll, chan_slabs=None,
                light_slabs=None, chunk: Optional[int] = None):
    """The general sweep: front-to-back composited base maps (acc, trans,
    wsum, hit), each (len(v_grid), len(u_grid)) float32, over an explicit
    slice subset and base-row subset, in plain PyTorch (the port of the JAX
    package's jnp sweep, ops/sweep.py _sweep_base). Each call adds one to
    the module's `general_calls`.

    gperm: the grid permuted so the sweep axis is dim 0 (D, A, B[, C]),
    read through _layer_lerp at each slice; lperm: an optional light
    volume in the same layout, of any shape (its own depth, and its own A,
    B for the in-plane resample); read only with emission. chan_slabs:
    optional pre-lerped slabs in slice order, in place of gperm: (S, C, A,
    B) channel slabs of the reference combine, or (S, A, B) layers of the
    single combine; light_slabs: optional (S, A', B') pre-lerped light
    layers in slice order, in place of lperm. With them a slab-local block
    of slices sweeps on its own (parallel/sweep_sharded.py); a slab's
    partial maps combine with composite_base_maps.

    Memory: the slices run in chunks of `chunk` slices (None: about
    sqrt(S)), each under torch.utils.checkpoint, so the backward keeps
    O(S / chunk) base images and recomputes one chunk at a time (the JAX
    package's two-level checkpointed scan and its `chunk`)."""
    global general_calls
    general_calls += 1
    low = cfg.dtype == "bfloat16"
    Hb, Wb = v_grid.shape[0], u_grid.shape[0]
    e_k, e_a, e_b = plan.eye01[0], plan.eye01[1], plan.eye01[2]
    lt = light if light is not None else LightConfig()
    offs = None
    if medium.combine == "reference":
        offs = sweep_ref_fwd._channel_offsets(medium, scroll,
                                              plan.coord_order,
                                              device=v_grid.device)
    S = slice_z.shape[0]
    if chunk is None:
        chunk = max(1, int(round(math.sqrt(S))))

    def slices(s0, s1, acc, trans, wsum, hit):
        for s in range(s0, s1):
            z_s = slice_z[s]
            delta = z_s - e_k
            a01 = e_a + delta * v_grid
            b01 = e_b + delta * u_grid
            front = (delta * plan.sign) > 0.0
            maskf = (_in01(a01)[:, None] & _in01(b01)[None, :]
                     & front).to(torch.float32)
            if chan_slabs is not None and medium.combine == "single":
                sigma = _resample_slice(chan_slabs[s], a01, b01,
                                        cfg.address_mode, low) \
                    * medium.sample_scale
            elif chan_slabs is not None:
                chan_s = chan_slabs[s]
                sigma = _combine_reference_inplane(
                    lambda c: chan_s[c], a01, b01, medium, offs,
                    cfg.address_mode, low)
            else:
                sigma = _sigma_general(gperm, z_s, a01, b01, medium, offs,
                                       cfg.address_mode, low)
            sigma = sigma * maskf
            if cfg.emission:
                live = (trans > cfg.early_stop_transmittance).to(
                    torch.float32)
                alpha = live * (1.0 - torch.exp(-medium.density * sigma
                                                * seglen))
                shade = 1.0
                lT = None
                if light_slabs is not None:
                    lT = light_slabs[s]
                elif lperm is not None:
                    lT = _layer_lerp(lperm, z_s, lperm.shape[0],
                                     cfg.address_mode)
                if lT is not None:
                    lT = _resample_slice(lT, a01, b01, cfg.address_mode, low)
                    shade = lt.ambient + (1.0 - lt.ambient) * clip_unit(lT)
                wsum = wsum + trans * alpha * shade
                trans = trans * (1.0 - alpha)
            else:
                acc = acc + sigma * seglen
                hit = torch.maximum(hit, maskf)
        return acc, trans, wsum, hit

    kw = dict(dtype=torch.float32, device=v_grid.device)
    carry = (torch.zeros((Hb, Wb), **kw), torch.ones((Hb, Wb), **kw),
             torch.zeros((Hb, Wb), **kw), torch.zeros((Hb, Wb), **kw))
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        if torch.is_grad_enabled():
            carry = checkpoint(slices, s0, s1, *carry, use_reentrant=False)
        else:
            carry = slices(s0, s1, *carry)
    return carry


def composite_base_maps(near, far):
    """Front-to-back combination of two composited base-map tuples, the
    associative (not commutative) monoid that makes a split of the slices
    exact: acc = acc1 + acc2, T = T1 * T2, wsum = w1 + T1 * w2, hit =
    max(h1, h2)."""
    acc1, t1, w1, h1 = near
    acc2, t2, w2, h2 = far
    return (acc1 + acc2, t1 * t2, w1 + t1 * w2, torch.maximum(h1, h2))


_GENERAL_WARNED = set()


def _general_sweep_reason(shape, cfg: RenderConfig, medium: MediumConfig,
                          light_volume, scroll):
    """Why no kernel covers this configuration on a grid of `shape` (the
    JAX package's Pallas gate, sweep_pallas.supported, refuses the same
    ones) when the general sweep does; None when the kernels cover it.
    Raises NotImplementedError for what neither covers."""
    ndim, lshape = len(shape), (None if light_volume is None
                                else tuple(light_volume.shape))
    if sweep_fwd.supported(cfg, medium, light_volume, scroll, ndim) \
            and lshape in (None, shape[:3]):
        return None
    ok = (cfg.dtype in ("float32", "bfloat16")
          and (lshape is None or len(lshape) == 3)
          and ((medium.combine == "single" and ndim == 3)
               or (medium.combine == "reference" and ndim == 4
                   and shape[-1] >= 4)))
    if not ok:
        raise NotImplementedError(
            "the torch sweep covers combine='single' (channel 0, no scroll) "
            "and combine='reference' with a (D, H, W, 4) grid and an "
            "optional (4, 3) scroll, in float32 or bfloat16, with an "
            "optional 3-D light volume; got combine="
            f"{medium.combine!r}, grid.shape={shape}, "
            f"dtype={cfg.dtype!r}, light volume shape={lshape}")
    if lshape is not None and lshape != shape[:3]:
        return f"a light volume of shape {lshape} on a grid of {shape[:3]}"
    return (f"combine={medium.combine!r} with address_mode="
            f"{cfg.address_mode!r}")


def sweep_config(grid, cfg: RenderConfig, medium: MediumConfig, scroll,
                 light_volume, shape=None):
    """The configuration as the sweeps take it: (grid, scroll,
    light_volume, general). Combine "single" reads channel 0 and no
    scroll; with absorption a light volume is never read (nor
    differentiated, as in the JAX package), so it is dropped. general:
    why no kernel covers the rest (the general sweep takes it), or None.
    shape: the whole grid's shape when `grid` is a block of it
    (parallel/sweep_sharded.py); by default grid's own. Raises
    NotImplementedError for what neither the kernels nor the general
    sweep cover."""
    shape = tuple(grid.shape if shape is None else shape)
    if medium.combine == "single":
        if grid.dim() == 4:
            grid, shape = grid[..., 0], shape[:3]
        scroll = None
    if light_volume is not None and light_volume.dim() == 3 \
            and not cfg.emission:
        light_volume = None
    general = _general_sweep_reason(shape, cfg, medium, light_volume, scroll)
    return grid, scroll, light_volume, general


class _RefFrameGraphs:
    """A 4-channel frame on the kernels as two CUDA graphs, captured from
    the eager frame's own calls: the channel layers (sweep_ref_inputs) from
    a static scroll, then K4 and finish_image from those layers. A replay
    runs what an eager frame runs, on the same memory, with no host work
    per kernel: two graph launches in place of ~80 launches from Python,
    which pace an eager frame of this medium. The graphs read the grid in place (an in-place change of it is seen)
    and hold it; the frame they return is a copy of their output, the
    caller's to keep. A replay counts K4's launch in
    sweep_ref_fwd.launches and records "sweep.ref_layers" (with its device
    interval) and "sweep.ref_fwd" around the two graphs; "warp.fwd" is not
    recorded on this path."""

    def __init__(self, gperm4, plan, cfg, medium, light, scroll):
        self.gperm4 = gperm4
        self.scroll = None if scroll is None else torch.empty(
            (4, 3), dtype=torch.float32, device=gperm4.device)
        launches = sweep_ref_fwd.launches
        self.layers, self.sweep = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.device(gperm4.device):
            with torch.cuda.graph(self.layers,
                                  capture_error_mode="thread_local"):
                self.L, _, _, _, _, self.params = \
                    sweep_ref_fwd.sweep_ref_inputs(gperm4, plan, cfg, medium,
                                                   light, self.scroll)
            with torch.cuda.graph(self.sweep, pool=self.layers.pool(),
                                  capture_error_mode="thread_local"):
                maps = sweep_ref_fwd.sweep_ref_apply(
                    self.L, None, plan.slice_z, plan.v_grid, plan.seglen,
                    self.params, plan, cfg, medium, light)
                self.out = finish_image(maps, plan, cfg, medium, light=light)
        self.k4 = sweep_ref_fwd.launches - launches  # captured, not run
        sweep_ref_fwd.launches = launches

    def replay(self, gperm4, scroll):
        with torch.cuda.device(self.gperm4.device):
            if self.scroll is not None:
                self.scroll.copy_(scroll)
            with clock.span("sweep.ref_layers", device=self.gperm4):
                self.layers.replay()
            with clock.span("sweep.ref_fwd"):
                self.sweep.replay()
            sweep_ref_fwd.launches += self.k4
            return self.out.clone()


class _RefStepGraphs:
    """A 4-channel frame under autograd on the kernels, without a scroll
    (a fit's step), as four CUDA graphs captured from the calls of an
    eager step: the channel layers (the taps and params are the plan's);
    K4 and finish_image from a static leaf of those layers, with their
    autograd graph; that graph's backward to the layers (the Beer-Lambert
    node's, W's splat, K5); and the layers' backward to the grid
    (_layer_adjoint). A replay (_RefStepReplay) runs what an eager step
    runs, on the same memory, with no host work per kernel: two graph
    launches each way in place of about 40 launches from Python, which
    pace an eager step of this medium. The graphs read the grid in place
    and hold it; the frame they return is a copy of their output, and the
    gradient a view of theirs, which autograd copies into the grid's own
    layout. A replay counts K4's launch, K5's and the layers' backward,
    and records "sweep.ref_layers" and "sweep.ref_layers_bwd" (with their
    device intervals), "sweep.ref_fwd" and "sweep.ref_bwd" around the
    graphs; "warp.fwd" and "warp.splat" are not recorded on this path."""

    def __init__(self, gperm4, plan, cfg, medium, light, scroll):
        counts = (sweep_ref_fwd.launches, sweep_ref_bwd.launches,
                  sweep_ref_fwd.layer_backwards)
        g = gperm4.detach()
        self.gperm4, self.shape = g, gperm4.shape
        self.taps, params = sweep_ref_fwd.taps_and_params(
            g.shape[0], plan, cfg, medium, light)
        self.graphs = [torch.cuda.CUDAGraph() for _ in range(4)]
        layers, sweep, sweep_bwd, layers_bwd = self.graphs
        with torch.cuda.device(g.device):
            with torch.cuda.graph(layers):
                self.L = sweep_ref_fwd._lerp_layers(g.to(torch.float32),
                                                    *self.taps)
            pool = layers.pool()
            self.L.requires_grad_()
            with torch.cuda.graph(sweep, pool=pool):
                maps = sweep_ref_fwd.sweep_ref_apply(
                    self.L, None, plan.slice_z, plan.v_grid, plan.seglen,
                    params, plan, cfg, medium, light)
                self.out = finish_image(maps, plan, cfg, medium, light=light)
            self.ct = torch.empty_like(self.out)
            with torch.cuda.graph(sweep_bwd, pool=pool):
                (self.dL,) = torch.autograd.grad(self.out, self.L, self.ct)
            with torch.cuda.graph(layers_bwd, pool=pool):
                self.grad = sweep_ref_fwd._layer_adjoint(self.dL, *self.taps,
                                                         self.shape)
        after = (sweep_ref_fwd.launches, sweep_ref_bwd.launches,
                 sweep_ref_fwd.layer_backwards)
        self.k4, self.k5, _ = (b - a for a, b in zip(counts, after))
        sweep_ref_fwd.launches, sweep_ref_bwd.launches, \
            sweep_ref_fwd.layer_backwards = counts

    def replay(self, gperm4, scroll):
        return _RefStepReplay.apply(gperm4, self)

    def forward(self):
        """The frame: the layers' and the sweep's graphs."""
        layers, sweep, _, _ = self.graphs
        with torch.cuda.device(self.gperm4.device):
            with clock.span("sweep.ref_layers", device=self.gperm4):
                layers.replay()
            with clock.span("sweep.ref_fwd"):
                sweep.replay()
            sweep_ref_fwd.launches += self.k4
            return self.out.detach().clone()

    def backward(self, ct):
        """The grid's gradient of the frame's cotangent ct."""
        _, _, sweep_bwd, layers_bwd = self.graphs
        with torch.cuda.device(self.gperm4.device):
            self.ct.copy_(ct)
            with clock.span("sweep.ref_bwd"):
                sweep_bwd.replay()
            with clock.span("sweep.ref_layers_bwd", device=self.ct):
                layers_bwd.replay()
            sweep_ref_bwd.launches += self.k5
            sweep_ref_fwd.layer_backwards += 1
            return self.grad


class _RefStepReplay(torch.autograd.Function):
    """A replay of _RefStepGraphs as the autograd node of the frame: its
    forward the frame's graphs, its backward the backward's."""

    @staticmethod
    def forward(ctx, gperm4, graphs):
        ctx.graphs, ctx.dtype = graphs, gperm4.dtype
        return graphs.forward()

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return ctx.graphs.backward(ct.contiguous()).to(ctx.dtype), None


class _RefFrameEntry:
    """A key's frames so far and, from its second, its graphs."""

    def __init__(self):
        self.seen, self.graphs = 0, None


REF_FRAME_GRAPHS = 16  # keys (grid, plan, configuration) kept, oldest out
_REF_FRAMES = IdentityCache(REF_FRAME_GRAPHS)
REF_STEP_GRAPHS = 2  # the same for frames under autograd (a fit's grid)
_REF_STEPS = IdentityCache(REF_STEP_GRAPHS)


def _ref_frame_entry(grid, plan, cfg, medium, light, scroll, lperm):
    """The entry of a 4-channel kernel frame that may run as CUDA graphs
    (_RefFrameGraphs), or None where it runs eagerly only: off CUDA, under
    autograd, with light slabs, or with a configuration that does not hash
    (a list in place of a tuple). A key's first two frames run eagerly;
    the second captures the graphs, unless spans are being recorded, and
    every later frame replays them. A camera rendered once (a new plan
    every frame) never pays for a capture."""
    if not grid.is_cuda or lperm is not None or (
            torch.is_grad_enabled() and grid.requires_grad):
        return None
    return _graphs_entry(_REF_FRAMES, grid, plan, cfg, medium, light, scroll)


def _ref_step_entry(grid, plan, cfg, medium, light, scroll, lperm):
    """As _ref_frame_entry, for a frame under autograd without a scroll or
    light slabs (a fit's step; _RefStepGraphs), or None."""
    if not grid.is_cuda or lperm is not None or scroll is not None or not (
            torch.is_grad_enabled() and grid.requires_grad):
        return None
    return _graphs_entry(_REF_STEPS, grid, plan, cfg, medium, light, scroll)


def _graphs_entry(cache, grid, plan, cfg, medium, light, scroll):
    try:
        return cache.get(
            (grid, plan.slice_z, plan.v_grid, plan.u_grid, plan.seglen),
            (cfg, medium, light, scroll is None), _RefFrameEntry)
    except TypeError:  # the key does not hash
        return None


def sweep_render(grid, plan: SweepPlan, cfg: RenderConfig,
                 medium: MediumConfig, light: Optional[LightConfig] = None,
                 scroll=None, light_volume=None, chunk: Optional[int] = None,
                 use_kernels: Optional[bool] = None):
    """Render one RGBA frame (H, W, 4) by sweeping slices front to back.

    grid: a (D, H, W) density grid with medium.combine "single", or a
    (D, H, W, 4) grid with "reference" and an optional (4, 3) per-channel
    scroll. A CUDA grid goes through the hand-written sweep kernels, a CPU
    grid through their plain PyTorch versions
    (kernels/sweep_fwd.sweep_base, kernels/sweep_ref_fwd.sweep_base_ref).
    With combine="single" the function is "channel 0, the scroll is
    ignored" (ops/integrate.sample_sigma): a (D, H, W, C) grid is swept as
    grid[..., 0] and a scroll is dropped, so the presets' (D, H, W, 1)
    grids take the single-channel kernels. The JAX package sends that form
    to its general jnp sweep, which computes the same function on another
    route.
    light_volume: optional 3-D light-transmittance grid (ops/lighting.py),
    the grid's spatial shape or another: with emission every sample is
    shaded by its clipped trilinear sample, and the frame is
    differentiable in it too.
    cfg.dtype "bfloat16" sweeps in the kernels' bfloat16 stream mode
    (kernels/sweep_fwd.py): texels and tap weights in bfloat16, everything
    else and the gradient in float32.
    The kernels take every configuration the JAX package's Pallas gate
    takes. The rest goes to the general sweep (_sweep_base), as in the JAX
    package: combine="reference" with clamp or wrap addressing, and a
    light volume of another shape than the grid's (sampled at its own
    resolution); that choice depends on the configuration only, and on a
    CUDA grid it is logged once per configuration. With absorption a light
    volume is never read (nor differentiated), so it is dropped and the
    kernels sweep. A float16 dtype, a 3-D grid with "reference" and a light
    volume that is not 3-D raise NotImplementedError.
    use_kernels (the JAX package's use_pallas): None routes as above; False
    sends every configuration to the general sweep, on any device and
    without the log line; True raises NotImplementedError where no kernel
    covers the configuration. chunk: the general sweep's checkpointed
    chunk of slices (None: about sqrt(S)); the kernels do not read it.
    A 4-channel kernel frame on a CUDA grid without autograd and without a
    light volume replays CUDA graphs from the third frame of its grid,
    plan and configuration on (_RefFrameGraphs): the same kernels on the
    same memory, bit for bit the eager frame. Under autograd without a
    scroll (a fit's step) the frame and its backward replay graphs the
    same way (_RefStepGraphs)."""
    grid, scroll, light_volume, general = sweep_config(
        grid, cfg, medium, scroll, light_volume)
    if use_kernels and general is not None:
        raise NotImplementedError(
            f"sweep_render(use_kernels=True): no kernel covers {general}")
    perm = plan.perm + ((3,) if grid.dim() == 4 else ())
    lperm = (light_volume.permute(plan.perm) if light_volume is not None
             else None)
    if general is not None or use_kernels is False:
        if general is not None and grid.device.type == "cuda" \
                and general not in _GENERAL_WARNED:
            _GENERAL_WARNED.add(general)
            get_logger().warning(
                "sweep: no kernel covers %s; this frame takes the general "
                "PyTorch sweep (a loop of matmuls per slice, far slower)",
                general)
        base_maps = _sweep_base(grid.permute(perm), lperm, plan.slice_z,
                                plan.v_grid, plan.u_grid, plan.seglen, plan,
                                cfg, medium, light, scroll, chunk=chunk)
    elif medium.combine == "reference":
        entry, graphs = _ref_frame_entry(grid, plan, cfg, medium, light,
                                         scroll, lperm), _RefFrameGraphs
        if entry is None:
            entry, graphs = _ref_step_entry(grid, plan, cfg, medium, light,
                                            scroll, lperm), _RefStepGraphs
        if entry is not None and entry.graphs is not None:
            return entry.graphs.replay(grid.permute(perm), scroll)
        base_maps = sweep_ref_fwd.sweep_base_ref(
            grid.permute(perm), plan, cfg, medium, light, scroll,
            lperm=lperm)
        out = finish_image(base_maps, plan, cfg, medium, light=light)
        if entry is not None:
            entry.seen += 1
            if entry.seen >= 2 and not clock.recording():
                entry.graphs = graphs(grid.permute(perm), plan, cfg, medium,
                                      light, scroll)
        return out
    else:
        base_maps = sweep_fwd.sweep_base(grid.permute(perm), plan, cfg,
                                         medium, light, lperm=lperm)
    return finish_image(base_maps, plan, cfg, medium, light=light)
