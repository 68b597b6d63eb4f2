"""Per-ray ray-march integrators in plain PyTorch (port of
volumetricrenderer_tpu/ops/integrate.py): the oracle the sweep is checked
against, and the "fixed" quadrature of fit_grid.

* render_rays: the reference's fixed-step march (box-local rays, slab
  intersection, step 4/max_steps, trilinear samples, front-to-back
  emission-absorption or Beer-Lambert absorption), one Python loop step
  per march step.
* render_rays_sliced: the same integral as the slice sweep (samples at the
  plan's slice-plane crossings, per-ray segment lengths), expressed per
  ray: the gradient check of bench.py holds the sweep to it.

Both are differentiable by ordinary autograd. The JAX versions wrap their
step in jax.checkpoint; here the oracle runs at small sizes only, so the
step intermediates are kept. sample_sigma covers both combines: channel 0
("single") and the reference medium's four channels at per-channel scaled
and scrolled coordinates. Shadows: render_rays marches a secondary ray
toward the light from every sample (_light_transmittance, with
light.shadow_steps > 0), and render_rays_sliced samples a precomputed
light-transmittance volume (ops/lighting.py), as the slice sweep does.
scene_sigma is the summed extinction of a multi-volume scene, the sigma_fn
of render.render_scene's per-ray backend.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import LightConfig, MediumConfig, RenderConfig
from .aabb import intersect_aabb
from .sampling import clip_unit, sample_trilinear

__all__ = [
    "reference_media_scroll",
    "sample_sigma",
    "scene_sigma",
    "render_rays",
    "render_rays_sliced",
    "transform_rays",
]


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def reference_media_scroll(t, n_channels=4, device=None):
    """Per-channel scroll 3-vectors from elapsed time t: only channel 0's
    x component is animated, as (-t, 0, 0). Returns (C, 3) float32."""
    scroll = torch.zeros((n_channels, 3), dtype=torch.float32, device=device)
    scroll[0, 0] = -_f32(t, device)
    return scroll


def transform_rays(origins, directions, world_to_local):
    """Apply a (4, 4) world_to_local transform to rays and renormalize the
    directions."""
    m = _f32(world_to_local, origins.device)
    o = origins @ m[:3, :3].T + m[:3, 3]
    d = directions @ m[:3, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return o, d


def sample_sigma(grid, pos01, medium: MediumConfig, scroll, address_mode):
    """Extinction density at normalized position(s) pos01 (..., 3).

    combine="reference": 4 channels, each sampled at pos01 scaled by its
    channel_coord_scale and shifted by scroll[c] * channel_scroll_weight[c]
    (scroll: (4, 3) or None), sigma = (s1*s2)*(s3+s4)*sample_scale;
    combine="single": channel 0 at pos01, sigma = s0 * sample_scale."""
    if medium.combine == "reference":
        if grid.dim() != 4 or grid.shape[-1] < 4:
            raise ValueError("reference combine needs a (D,H,W,4) grid")
        if scroll is not None:
            scroll = _f32(scroll, grid.device)
        samples = []
        for c in range(4):
            coord = pos01 * medium.channel_coord_scale[c]
            if scroll is not None:
                coord = coord + scroll[c] * medium.channel_scroll_weight[c]
            samples.append(sample_trilinear(grid[..., c], coord,
                                            address_mode))
        s1, s2, s3, s4 = samples
        return (s1 * s2) * (s3 + s4) * medium.sample_scale
    if medium.combine == "single":
        g = grid[..., 0] if grid.dim() == 4 else grid
        return sample_trilinear(g, pos01, address_mode) * medium.sample_scale
    raise ValueError(f"unknown combine mode {medium.combine!r}")


def scene_sigma(volumes, pos01, cfg: RenderConfig, medium: MediumConfig,
                scroll=None):
    """Summed extinction of a multi-volume scene at shared-box normalized
    positions pos01 (..., 3). Each volume (models.scene.Volume) carries its
    own world_to_local; densities of overlapping volumes add (independent
    scatterers). A position outside a volume's own [0, 1] box contributes
    zero there, not an address-mode repeat: each volume is a finite
    object."""
    dev = pos01.device
    box_min = _f32(cfg.box_min, dev)
    box_range = _f32(cfg.box_max, dev) - box_min
    world = pos01 * box_range + box_min
    total = torch.zeros(pos01.shape[:-1], dtype=torch.float32, device=dev)
    for vol in volumes:
        if vol.world_to_local is None:
            p = pos01
        else:
            m = _f32(vol.world_to_local, dev)
            local = world @ m[:3, :3].T + m[:3, 3]
            p = (local - box_min) / box_range
        inside = torch.all((p >= 0.0) & (p <= 1.0), dim=-1)
        s = sample_sigma(vol.grid, p, medium, scroll, cfg.address_mode)
        total = total + torch.where(inside, s, torch.zeros_like(s))
    return total


def _light_transmittance(grid, pos01, medium, scroll, cfg: RenderConfig,
                         light: LightConfig, sigma_fn=None):
    """The secondary shadow march: from pos01 toward the light in
    light.shadow_steps steps of light.shadow_step_size, summing the
    extinction inside the box; returns exp(-density * integral)."""
    dev = pos01.device
    ldir = _f32(light.direction, dev)
    ldir = ldir / torch.linalg.norm(ldir)
    box_range = _f32(cfg.box_max, dev) - _f32(cfg.box_min, dev)
    step01 = light.shadow_step_size * ldir / box_range
    acc = torch.zeros(pos01.shape[:-1], dtype=torch.float32, device=dev)
    for i in range(light.shadow_steps):
        p = pos01 + step01 * (i + 1.0)
        inside = torch.all((p >= 0.0) & (p <= 1.0), dim=-1)
        if sigma_fn is not None:
            sigma = sigma_fn(p)
        else:
            sigma = sample_sigma(grid, p, medium, scroll, cfg.address_mode)
        acc = acc + torch.where(inside, sigma, torch.zeros_like(sigma))
    return torch.exp(-medium.density * acc * light.shadow_step_size)


def render_rays(
    grid,
    origins,
    directions,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    world_to_local=None,
    sigma_fn=None,
):
    """March rays through the volume. Returns RGBA, shape (..., 4).

    grid: (D, H, W) or (D, H, W, C) float grid in [0, 1];
    origins/directions: (..., 3) world-space rays on the grid's device.
    sigma_fn: optional pos01 -> extinction override replacing the single
    grid sample (grid may then be None); the shadow march uses the same
    field."""
    if world_to_local is not None:
        origins, directions = transform_rays(origins, directions,
                                             world_to_local)
    dev = origins.device
    box_min = _f32(cfg.box_min, dev)
    box_max = _f32(cfg.box_max, dev)
    box_range = box_max - box_min

    t_near, t_far = intersect_aabb(origins, directions, box_min, box_max)
    hit = (t_near <= t_far) & (t_far > 0.0)
    # The entry clamps to the camera plane (the reference never has the
    # camera inside the box).
    t0 = torch.clamp(t_near, min=0.0)

    step = cfg.step_size
    n_steps = torch.minimum(
        _f32(cfg.max_steps, dev),
        torch.floor(torch.clamp(t_far - t0, min=0.0) / step))
    n_steps = torch.where(hit, n_steps, torch.zeros_like(n_steps))

    pos = (origins + directions * t0[..., None] - box_min) / box_range
    step01 = step * directions / box_range

    emission = cfg.emission
    lt = light if light is not None else LightConfig()
    use_shadow = emission and lt.shadow_steps > 0
    lcol = _f32(lt.color, dev)

    batch_shape = origins.shape[:-1]
    accum = torch.zeros(batch_shape, dtype=torch.float32, device=dev)
    trans = torch.ones(batch_shape, dtype=torch.float32, device=dev)
    color = torch.zeros(batch_shape + (3,), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(cfg.max_steps):
        active = float(i) < n_steps
        if emission:
            # Transmittance early-out: a masked no-op on opaque rays.
            active = active & (trans > cfg.early_stop_transmittance)
        if sigma_fn is not None:
            sigma = sigma_fn(pos)
        else:
            sigma = sample_sigma(grid, pos, medium, scroll, cfg.address_mode)
        sigma = torch.where(active, sigma, zero)
        if emission:
            alpha = 1.0 - torch.exp(-medium.density * sigma * step)
            if use_shadow:
                lT = _light_transmittance(grid, pos, medium, scroll, cfg, lt,
                                          sigma_fn=sigma_fn)
            else:
                lT = 1.0
            shade = lt.ambient + (1.0 - lt.ambient) * lT
            contrib = (trans * alpha * shade)[..., None] * lcol
            color = color + torch.where(active[..., None], contrib, zero)
            trans = trans * torch.where(active, 1.0 - alpha,
                                        torch.ones_like(alpha))
        else:
            accum = accum + sigma
        pos = pos + step01

    background = _f32(cfg.background, dev)
    if emission:
        rgb = color + trans[..., None] * background
        alpha = 1.0 - trans
    else:
        gray = 1.0 - torch.exp(-medium.density * accum * step)
        rgb = torch.where(hit[..., None], gray[..., None],
                          background.expand(batch_shape + (3,)))
        alpha = hit.to(torch.float32)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def render_rays_sliced(
    grid,
    origins,
    directions,
    plan,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    light_volume=None,
    sigma_fn=None,
):
    """Gather-based oracle for the sliced quadrature (ops/sweep.py).

    Marches each ray by sampling at the sweep plan's slice-plane crossings
    with per-ray segment lengths: the integral the slice sweep computes,
    expressed per ray (slow; for tests and gradient checks). light_volume:
    optional (D, H, W) light-transmittance grid (ops/lighting.py), sampled
    trilinearly at every sample and clipped to [0, 1] for the shade."""
    dev = origins.device
    box_min = _f32(cfg.box_min, dev)
    box_range = _f32(cfg.box_max, dev) - box_min
    c_k, c_a, c_b = plan.coord_order
    w = directions / box_range
    e01 = (origins - box_min) / box_range
    wk = w[..., c_k]
    u = w[..., c_b] / wk
    v = w[..., c_a] / wk
    S = plan.slice_z.shape[0]
    rng = plan.box_range  # (k, a, b) order
    seglen = (1.0 / S) * torch.sqrt(
        rng[0] ** 2 + (v * rng[1]) ** 2 + (u * rng[2]) ** 2)

    lt = light if light is not None else LightConfig()
    lcol = _f32(lt.color, dev)
    batch_shape = origins.shape[:-1]
    emission = cfg.emission

    acc = torch.zeros(batch_shape, dtype=torch.float32, device=dev)
    trans = torch.ones(batch_shape, dtype=torch.float32, device=dev)
    color = torch.zeros(batch_shape + (3,), dtype=torch.float32, device=dev)
    hitm = torch.zeros(batch_shape, dtype=torch.float32, device=dev)
    for s in range(S):
        z_s = plan.slice_z[s]
        delta = z_s - e01[..., c_k]
        pa = e01[..., c_a] + delta * v
        pb = e01[..., c_b] + delta * u
        comps = [None] * 3
        comps[c_k] = z_s.expand(batch_shape)
        comps[c_a] = pa
        comps[c_b] = pb
        pos = torch.stack(comps, dim=-1)
        inbox = ((pa >= 0.0) & (pa <= 1.0) & (pb >= 0.0) & (pb <= 1.0)
                 & (delta * plan.sign > 0.0))
        maskf = inbox.to(torch.float32)
        if sigma_fn is not None:
            sigma = sigma_fn(pos)
        else:
            sigma = sample_sigma(grid, pos, medium, scroll, cfg.address_mode)
        sigma = sigma * maskf
        if emission:
            live = (trans > cfg.early_stop_transmittance).to(torch.float32)
            alpha = live * (1.0 - torch.exp(-medium.density * sigma * seglen))
            if light_volume is not None:
                lT = sample_trilinear(light_volume, pos, cfg.address_mode)
                shade = lt.ambient + (1.0 - lt.ambient) * clip_unit(lT)
            else:
                shade = 1.0
            wgt = trans * alpha * shade
            color = color + wgt[..., None] * lcol
            trans = trans * (1.0 - alpha)
        else:
            acc = acc + sigma * seglen
            hitm = torch.maximum(hitm, maskf)

    background = _f32(cfg.background, dev)
    if emission:
        rgb = color + trans[..., None] * background
        alpha = 1.0 - trans
    else:
        gray = 1.0 - torch.exp(-medium.density * acc)
        hitp = torch.clamp(hitm, 0.0, 1.0)
        rgb = (gray[..., None] * hitp[..., None]
               + background * (1.0 - hitp[..., None]))
        alpha = hitp
    return torch.cat([rgb, alpha[..., None]], dim=-1)
