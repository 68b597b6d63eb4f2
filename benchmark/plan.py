"""Cameras and sweep geometry, worked out by the benchmark itself.

A frozen copy, taken at commit 38e9ffd, of the port's look-at camera
(volumetricrenderer_tpu_torch/ops/camera.py look_at_camera) and of its
sweep plan (ops/sweep.py _camera_rays_np, _host_geometry, plan_sweep and
plan_base_dims; cli.py animation_base_dims). The reference renders and the
roofline count read this geometry; neither ever reads the port's plan
object.

A camera is a plain dict (traffic.py makes them): eye, center, up,
fov_y_degrees, width, height. Its basis is formed in float32 on the CPU as
the port forms it, and the plan's host part in float64 numpy, its
per-pixel maps in float32 on the render device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BOX_MIN, BOX_MAX = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)


def camera_basis(cam: dict):
    """(eye, right, up, forward, tan_half_fov) float32 CPU tensors."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    eye = f32(cam["eye"])
    forward = f32(cam["center"]) - eye
    forward = forward / torch.linalg.norm(forward)
    right = torch.linalg.cross(forward, f32(cam["up"]))
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, forward)
    tan_half = torch.tan(torch.deg2rad(f32(cam["fov_y_degrees"])) / 2.0)
    return eye, right, up, forward, tan_half


def _axes_for(coord_axis):
    gd_k = 2 - coord_axis
    rest = [d for d in range(3) if d != gd_k]
    return (gd_k, rest[0], rest[1]), (coord_axis, 2 - rest[0], 2 - rest[1])


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def host_geometry(cam: dict, grid_shape, supersample=1.5, force_dims=None,
                  max_base_dim=3072, min_axis_component=0.05):
    """The plan's host part: sweep axis and sign, the base grid's slope
    axes and the slice positions, front to back."""
    eye, right, up, forward, tan_half = (
        np.asarray(t.numpy(), np.float64) for t in camera_basis(cam))
    tan_half = float(tan_half)
    w_px, h_px = int(cam["width"]), int(cam["height"])
    xs = (np.arange(w_px, dtype=np.float64) + 0.5) / w_px * 2.0 - 1.0
    ys = 1.0 - (np.arange(h_px, dtype=np.float64) + 0.5) / h_px * 2.0
    px, py = np.meshgrid(xs, ys, indexing="xy")
    d = (px[..., None] * (right * tan_half * (w_px / h_px))
         + py[..., None] * (up * tan_half) + forward)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    box_min = np.asarray(BOX_MIN, np.float64)
    box_range = np.asarray(BOX_MAX, np.float64) - box_min
    e01_xyz = (eye - box_min) / box_range
    w = d / box_range
    min_abs = np.abs(w).reshape(-1, 3).min(axis=0)
    axis = int(np.argmax(min_abs))
    if min_abs[axis] < min_axis_component:
        raise ValueError("no sweep axis for this camera")
    wk = w[..., axis]
    sign = int(np.sign(wk.reshape(-1)[0]))
    if not np.all(np.sign(wk) == sign):
        raise ValueError("mixed ray direction signs along the sweep axis")
    perm, coord_order = _axes_for(axis)
    c_k, c_a, c_b = coord_order
    u, v = w[..., c_b] / wk, w[..., c_a] / wk
    S = int(grid_shape[perm[0]])
    z01 = (np.arange(S) + 0.5) / S
    slice_z = z01 if sign > 0 else z01[::-1]
    deltas = z01 - e01_xyz[c_k]
    front = deltas * sign > 0
    delta_near = deltas[front][np.argmin(np.abs(deltas[front]))] \
        if front.any() else None

    def base_axis(q, e_t, n_force):
        th = np.arctan(q)
        lo, hi = float(q.min()), float(q.max())
        if delta_near is not None and abs(delta_near) > 0.02:
            far = float(deltas[front].max() if sign > 0
                        else deltas[front].min())
            cand = [(b - e_t) / dd for b in (0.0, 1.0)
                    for dd in (delta_near, far)]
            lo, hi = max(lo, min(cand)), min(hi, max(cand))
            if not lo < hi:
                lo, hi = float(q.min()), float(q.max())
        th_lo, th_hi = math.atan(lo), math.atan(hi)
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

    fh, fw = force_dims if force_dims is not None else (None, None)
    u_grid, thu_lo, thu_hi, Wb = base_axis(u, e01_xyz[c_b], fw)
    v_grid, thv_lo, thv_hi, Hb = base_axis(v, e01_xyz[c_a], fh)
    return dict(axis=axis, sign=sign, perm=perm, coord_order=coord_order,
                e01_xyz=e01_xyz, u_grid=u_grid, v_grid=v_grid, thu_lo=thu_lo,
                thu_hi=thu_hi, thv_lo=thv_lo, thv_hi=thv_hi, Hb=Hb, Wb=Wb,
                slice_z=slice_z, S=S, box_range=box_range,
                rng_perm=box_range[[c_k, c_a, c_b]])


def shared_dims(cams, grid_shape, supersample=1.5):
    """The base dims every camera of an animated path is planned at: the
    largest natural dims of each axis over the path."""
    geo = [host_geometry(c, grid_shape, supersample) for c in cams]
    return max(g["Hb"] for g in geo), max(g["Wb"] for g in geo)


def make_plan(cam: dict, grid_shape, device, supersample=1.5,
              force_dims=None) -> dict:
    """The sweep plan as a dict of float32 tensors on `device` (eye01,
    v_grid, u_grid, slice_z, seglen, rows01, cols01) beside the host
    fields (sign, perm, S, Hb, Wb)."""
    g = host_geometry(cam, grid_shape, supersample, force_dims)
    c_k, c_a, c_b = g["coord_order"]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    _, right, up, forward, tan_half = (t.to(device)
                                       for t in camera_basis(cam))
    rng = f32(g["rng_perm"])
    v_grid, u_grid = f32(g["v_grid"]), f32(g["u_grid"])
    seglen = (1.0 / g["S"]) * torch.sqrt(
        rng[0] ** 2 + (v_grid[:, None] * rng[1]) ** 2
        + (u_grid[None, :] * rng[2]) ** 2)
    width, height = int(cam["width"]), int(cam["height"])
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=device)
                + 0.5) / height * 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    dirs = (px[..., None] * (right * tan_half * float(width / height))
            + py[..., None] * (up * tan_half) + forward)
    w = dirs / f32(g["box_range"])
    u, v = w[..., c_b] / w[..., c_k], w[..., c_a] / w[..., c_k]
    thv_lo, thv_hi, thu_lo, thu_hi = (f32(g[k]) for k in
                                      ("thv_lo", "thv_hi", "thu_lo", "thu_hi"))
    return dict(
        eye01=f32(g["e01_xyz"][[c_k, c_a, c_b]]), v_grid=v_grid,
        u_grid=u_grid, slice_z=f32(np.ascontiguousarray(g["slice_z"])),
        seglen=seglen,
        rows01=(torch.atan(v) - thv_lo) / (thv_hi - thv_lo),
        cols01=(torch.atan(u) - thu_lo) / (thu_hi - thu_lo),
        sign=g["sign"], perm=g["perm"], S=g["S"], Hb=g["Hb"], Wb=g["Wb"])
