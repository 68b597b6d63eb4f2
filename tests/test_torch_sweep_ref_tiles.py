"""The host side of K4's and K5's tiled schedule (kernels/build.py
ref_tile_spans, ref_stage_texels, ref_stage_bound, ref_stage_for,
ref_stage_cap, ref_tile_slices), which mirrors the kernels' channel-window
arithmetic (kernels/csrc/sweep_ref_tile.cuh) and sizes their shared-memory
stage. The kernels cannot run here; these tests hold the arithmetic they
share with the host to the channel taps of the plain versions' sampler.

For every plan and scroll: every line in front of the eye and inside the box
has its channel taps t and t + 1, computed with the kernels' float32
expressions (x * sc + off, then * n - 0.5, floor), inside its channel's
tile-slice window [lo, hi], and the window's slot t - lo holds, through the
slot -> texel map mirror(lo + m), the texel the sampler reads (ops/resample
linear_taps, mirror); the slice lies in the tile's slice range; the
offset-free stage bound holds every window for every scroll tried; the
tally mirror counts the active tile-slices and those over a stage. Plans:
the five eyes of tests/test_sweep_pallas.py (both signs of each axis), a
sub-voxel stack, ragged base grids, seeded (4, 3) scrolls in [-1.5, 1.5]
(their windows cross mirror folds), and media whose channel scales exceed 1
(a window wider than the mirror's period 2n) or are negative. Integer and
float32 arithmetic on small shapes: exact, no tolerance.
"""
import os

import numpy as np
import pytest
import torch

from volumetricrenderer_tpu_torch.config import (CameraConfig, LightConfig,
                                                 MediumConfig, RenderConfig)
from volumetricrenderer_tpu_torch.kernels import build, sweep_fwd, \
    sweep_ref_fwd
from volumetricrenderer_tpu_torch.ops.camera import make_camera
from volumetricrenderer_tpu_torch.ops.resample import linear_taps
from volumetricrenderer_tpu_torch.ops.sampling import apply_address_mode
from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep

torch.set_num_threads(1)

EYES = [(3.0, 0.4, 0.3), (-3.0, 0.4, 0.3), (0.3, 3.0, 0.4),
        (0.4, 0.3, 3.0), (0.4, 0.3, -3.0)]
SCROLL_SEEDS = (5, 6, 7)
WIDE = MediumConfig(channel_coord_scale=(2.5, 0.8, 3.1, 0.7))
FLIPPED = MediumConfig(channel_coord_scale=(1.0, -0.8, 0.75, 0.7))


def _scroll(seed, spread=1.5):
    return torch.tensor(np.random.default_rng(seed).uniform(
        -spread, spread, (4, 3)), dtype=torch.float32)


def _plan(eye, shape=(16, 16, 16), n_slices=None, force=None, width=96,
          height=64):
    cfg = RenderConfig(emission=True, quadrature="sliced")
    plan = plan_sweep(make_camera(CameraConfig(eye=eye, width=width,
                                               height=height)),
                      shape, cfg, supersample=cfg.sweep_supersample,
                      n_slices=n_slices, force_base_dims=force)
    return plan, cfg


def _inputs(plan, cfg, medium, scroll, shape=(16, 16, 16)):
    """(slice_z, v, u, params, A, B) of the 4-channel sweep."""
    gperm4 = torch.zeros(shape + (4,)).permute(plan.perm + (3,))
    L, slice_z, v, u, _, params = sweep_ref_fwd.sweep_ref_inputs(
        gperm4, plan, cfg, medium, None, scroll)
    return slice_z, v, u, params, L.shape[2], L.shape[3]


def _check_axis(e, delta, q, n, span, tile, front, params, off_at):
    """Each channel's taps of each line in the box on an in-front slice:
    inside its tile's window, and the window's slot -> texel map gives the
    sampler's texels. Returns the (lines, S) in-box mask."""
    lo, hi, any_in = span
    x = e + delta[None, :] * q[:, None]
    inbox = (x >= 0.0) & (x <= 1.0) & front[None, :]
    tile_of = torch.arange(q.shape[0]) // tile
    assert bool((any_in[tile_of] | ~inbox).all())
    for c in range(build.NCH):
        coord = x * params[8 + c] + params[off_at + c]
        t = torch.floor(coord * n - 0.5).to(torch.int64)
        w_lo, w_hi = lo[c][tile_of], hi[c][tile_of]
        assert bool(((w_lo <= t) & (t + 1 <= w_hi) | ~inbox).all())
        # The slots t - lo and t + 1 - lo hold the sampler's texels.
        a0, a1, _, _ = linear_taps(coord[inbox], n, "mirror")
        m = (t - w_lo)[inbox]
        lo_in = w_lo[inbox]
        assert torch.equal(apply_address_mode(lo_in + m, n, "mirror"), a0)
        assert torch.equal(apply_address_mode(lo_in + m + 1, n, "mirror"),
                           a1)
    return inbox


def _areas(spans, light_spans=None):
    """The test's own count: (active, windows' slots) per tile-slice."""
    front, (rlo, rhi, rany), (clo, chi, cany) = spans
    active = front[None, None, :] & rany[:, None, :] & cany[None, :, :]
    areas = [(rhi[c] - rlo[c] + 1)[:, None, :] * (chi[c] - clo[c] + 1)[None]
             for c in range(build.NCH)]
    if light_spans is not None:
        _, (lr0, lr1, _), (lc0, lc1, _) = light_spans
        areas.append((lr1 - lr0 + 1)[:, None, :] * (lc1 - lc0 + 1)[None])
    return active, torch.stack(areas)


def _check_plan(slice_z, v, u, params, A, B, light=False):
    spans = build.ref_tile_spans(slice_z, v, u, params, A, B)
    front, rows, cols = spans
    delta = slice_z - params[0]
    rin = _check_axis(params[1], delta, v, A, rows, build.TILE_ROWS, front,
                      params, 16)
    cin = _check_axis(params[2], delta, u, B, cols, build.TILE_COLS, front,
                      params, 12)
    # The slice range: a tile-slice with a sample in the box is active.
    rt = torch.arange(v.shape[0]) // build.TILE_ROWS
    ct = torch.arange(u.shape[0]) // build.TILE_COLS
    light_spans = (build.tile_spans(slice_z, v, u, params, A, B, False)
                   if light else None)
    active, areas = _areas(spans, light_spans)
    sample = rin[:, None, :] & cin[None, :, :]
    assert bool((active[rt][:, ct] | ~sample).all())
    assert bool(sample.any())
    # The largest window, and the tally against a stage of that size, of
    # none and of half of it.
    most = areas.max(0).values
    need = build.ref_stage_texels(spans, light_spans)
    assert need == int(most[active].max())
    n_active = int(active.sum())
    assert build.ref_tile_slices(spans, need, light_spans) == (n_active, 0)
    assert build.ref_tile_slices(spans, 0, light_spans) == (n_active,
                                                            n_active)
    half = build.ref_tile_slices(spans, need // 2, light_spans)
    assert half == (n_active, int((most[active] > need // 2).sum()))
    return need


def _check_bound(plan, cfg, medium, shape=(16, 16, 16), light=False,
                 seeds=SCROLL_SEEDS, spread=1.5):
    """The offset-free bound holds the windows of every scroll tried (and
    of none), and no scroll changes it."""
    bounds, needs = set(), []
    for scroll in [None] + [_scroll(s, spread) for s in seeds]:
        slice_z, v, u, params, A, B = _inputs(plan, cfg, medium, scroll,
                                              shape)
        needs.append(_check_plan(slice_z, v, u, params, A, B, light))
        bounds.add(build.ref_stage_bound(slice_z, v, u, params,
                                         medium.channel_coord_scale, A, B,
                                         light))
    assert len(bounds) == 1
    bound = bounds.pop()
    assert max(needs) <= bound
    return bound, needs


@pytest.mark.parametrize("seed", SCROLL_SEEDS)
@pytest.mark.parametrize("eye", EYES)
def test_channel_taps_lie_in_their_windows(eye, seed):
    plan, cfg = _plan(eye)
    _check_plan(*_inputs(plan, cfg, MediumConfig(), _scroll(seed)))


@pytest.mark.parametrize("case", [
    dict(eye=EYES[0], n_slices=24),
    dict(eye=EYES[1], force=(100, 70)),
    dict(eye=EYES[2], force=(70, 100)),
    dict(eye=EYES[3], force=(33, 95)),
    dict(eye=EYES[4], force=(20, 20), medium=WIDE),
    dict(eye=EYES[0], force=(20, 20), medium=WIDE, n_slices=11),
    dict(eye=EYES[2], medium=FLIPPED),
    dict(eye=(0.9, 0.8, 1.6), shape=(15, 17, 13)),
    dict(eye=EYES[3], light=True),
    dict(eye=EYES[1], force=(20, 20), medium=WIDE, light=True),
], ids=["sub-voxel", "ragged 100x70", "ragged 70x100", "ragged 33x95",
        "scale above 1", "scale above 1 sub-voxel", "negative scale",
        "near eye odd shape", "light", "scale above 1 with light"])
def test_channel_windows_edge_plans(case):
    shape = case.get("shape", (16, 16, 16))
    plan, cfg = _plan(case["eye"], shape, case.get("n_slices"),
                      case.get("force"))
    _check_bound(plan, cfg, case.get("medium", MediumConfig()), shape,
                 case.get("light", False))


@pytest.mark.parametrize("eye", EYES)
def test_offset_free_bound_holds_every_scroll(eye):
    """The bound from the plan and the scales alone holds the windows of
    seeded scrolls in [-1.5, 1.5] and of scrolls forty times as large."""
    plan, cfg = _plan(eye)
    bound, needs = _check_bound(plan, cfg, MediumConfig())
    assert _check_bound(plan, cfg, MediumConfig(), seeds=(8, 9),
                        spread=40.0)[0] == bound
    # A window is the scaled span plus at most three slots per axis: the
    # bound is no looser than that.
    assert bound <= (int(max(needs) ** 0.5) + 3) ** 2


def test_window_wider_than_the_mirror_period():
    """A channel scale above 1 on a coarse base makes a window span more
    than the period 2n, so several slots hold one texel."""
    plan, cfg = _plan(EYES[3], force=(20, 20))
    slice_z, v, u, params, A, B = _inputs(plan, cfg, WIDE, _scroll(5))
    front, (rlo, rhi, rany), _ = build.ref_tile_spans(slice_z, v, u, params,
                                                      A, B)
    extent = (rhi - rlo + 1)[:, rany & front[None, :]]
    assert int(extent.max()) > 2 * A


def test_stage_for_is_sized_once_per_plan_and_medium():
    """The sweep sizes the stage from its per-plan params and the medium's
    scales: frames with new scrolls find it in the cache, a new medium
    computes it anew, and it equals the bound of the scrolled params."""
    plan, cfg = _plan(EYES[3])
    lt = LightConfig()
    base = sweep_fwd._params_for(plan, cfg, MediumConfig(), lt)
    calls = []
    real = build.ref_stage_bound

    def counted(*args):
        calls.append(1)
        return real(*args)
    build.ref_stage_bound = counted
    try:
        first = build.ref_stage_for(plan.slice_z, plan.v_grid, plan.u_grid,
                                    base, 16, 16,
                                    MediumConfig().channel_coord_scale)
        for seed in SCROLL_SEEDS:
            *_, params, _, _ = _inputs(plan, cfg, MediumConfig(),
                                       _scroll(seed))
            assert params is not base
            again = sweep_fwd._params_for(plan, cfg, MediumConfig(), lt)
            assert again is base
            assert build.ref_stage_for(
                plan.slice_z, plan.v_grid, plan.u_grid, again, 16, 16,
                MediumConfig().channel_coord_scale) == first
        assert len(calls) == 1
        build.ref_stage_for(plan.slice_z, plan.v_grid, plan.u_grid, base,
                            16, 16, WIDE.channel_coord_scale)
        assert len(calls) == 2
    finally:
        build.ref_stage_bound = real
    slice_z, v, u, params, A, B = _inputs(plan, cfg, MediumConfig(),
                                          _scroll(5))
    assert first == real(slice_z, v, u, params,
                         MediumConfig().channel_coord_scale, A, B, False)


def test_ref_stage_cap_bounds_the_shared_memory():
    """ref_stage_cap keeps a launch's windows within STAGE_BYTES_MAX and
    within REF_MAX_SLOTS over its windows."""
    for backward in (False, True):
        for light in (False, True):
            nw = build.ref_windows(light)
            buffers = nw * (2 + (8 if backward else 0))
            cap = build.ref_stage_cap(10 ** 9, backward, light)
            assert cap * 4 * buffers <= build.STAGE_BYTES_MAX
            assert cap * nw <= build.REF_MAX_SLOTS
            assert build.ref_stage_cap(196, backward, light) == 196
            assert build.ref_stage_cap(0, backward, light) == 0
    assert [build.ref_windows(light) for light in (False, True)] == [4, 5]


@pytest.mark.parametrize("name", ["sweep_ref_fwd", "sweep_ref_bwd"])
def test_ref_build_key_covers_the_tile_headers(name):
    """An edited header of the tiled schedule rebuilds K4 and K5: their
    libraries' names hash every header they include."""
    src = os.path.join(build.CSRC, name + ".cu")
    names = [os.path.basename(p) for p in build._source_files(src)]
    assert names == sorted([name + ".cu", "sweep_common.cuh",
                            "sweep_ref_common.cuh", "sweep_ref_tile.cuh",
                            "sweep_tile.cuh"])
