"""The host side of K1's and K2's tiled schedule (kernels/build.py
tile_spans, stage_texels, stage_for, tile_slices), which mirrors the
kernels' window arithmetic (kernels/csrc/sweep_tile.cuh) and sizes their
shared-memory stage. The kernels cannot run here; these tests hold the
arithmetic they share with the host to the sample taps.

For every plan: every sample in front of the eye and inside the box has its
four taps, computed with the kernels' float32 tap formula (a01 = e_a +
delta * v, p = a01 * n - 0.5, floor), inside its tile-slice's window, and
its slice inside its tile's slice range (the active tile-slices); the stage
holds every active window. Plans: the five eyes of tests/test_sweep_pallas.py
with mirror, clamp and wrap (sign < 0 is the kernels' `flip`), a sub-voxel
stack (n_slices != depth), ragged base grids that are no multiple of the
tile, and grids with more texels than base pixels. Integer and float32
arithmetic on small shapes: exact, no tolerance.
"""
import pytest
import torch

from volumetricrenderer_tpu_torch.config import (CameraConfig, LightConfig,
                                                 MediumConfig, RenderConfig)
from volumetricrenderer_tpu_torch.kernels import build, sweep_fwd
from volumetricrenderer_tpu_torch.ops.camera import make_camera
from volumetricrenderer_tpu_torch.ops.resample import linear_taps
from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep

torch.set_num_threads(1)

EYES = [(3.0, 0.4, 0.3), (-3.0, 0.4, 0.3), (0.3, 3.0, 0.4),
        (0.4, 0.3, 3.0), (0.4, 0.3, -3.0)]
MEDIUM = MediumConfig(combine="single", density=8.0)


def _inputs(eye, mode="mirror", shape=(16, 16, 16), n_slices=None,
            force=None, width=96, height=64):
    cfg = RenderConfig(emission=True, quadrature="sliced", address_mode=mode)
    plan = plan_sweep(make_camera(CameraConfig(eye=eye, width=width,
                                               height=height)),
                      shape, cfg, supersample=cfg.sweep_supersample,
                      n_slices=n_slices, force_base_dims=force)
    gperm = torch.zeros(shape).permute(plan.perm)
    (stack, slice_z, v, u, _, params), _ = sweep_fwd.sweep_inputs(
        gperm, plan, cfg, MEDIUM, LightConfig())
    S, A, B = stack.shape
    return slice_z, v, u, params, S, A, B, mode == "wrap"


def _check_axis(e, delta, q, n, span, tile, wrap, mode, front):
    """Each line in the box on an in-front slice: its taps inside its
    tile's window, and its tile-slice marked as holding a line in the box.
    Returns the (lines, S) in-box mask."""
    lo, hi, any_in = span
    x = e + delta[None, :] * q[:, None]
    inbox = (x >= 0.0) & (x <= 1.0) & front[None, :]
    t = torch.floor(x * n - 0.5).to(torch.int64)
    i0, i1 = (t, t + 1) if wrap else (t.clamp(0, n - 1),
                                      (t + 1).clamp(0, n - 1))
    tile_of = torch.arange(q.shape[0]) // tile
    lo, hi, any_in = lo[tile_of], hi[tile_of], any_in[tile_of]
    assert bool((any_in | ~inbox).all())
    assert bool(((lo <= i0) & (i0 <= i1) & (i1 <= hi) | ~inbox).all())
    # The unwrapped taps are the sampler's own once the mode folds them.
    a0, a1, _, _ = linear_taps(x[inbox], n, mode)
    fold = (lambda i: torch.remainder(i, n)) if wrap else (lambda i: i)
    assert torch.equal(fold(i0[inbox]), a0) and torch.equal(fold(i1[inbox]),
                                                            a1)
    return inbox


def _check_plan(slice_z, v, u, params, S, A, B, wrap, mode):
    spans = build.tile_spans(slice_z, v, u, params, A, B, wrap)
    front, rows, cols = spans
    e_k, e_a, e_b = params[0], params[1], params[2]
    delta = slice_z - e_k
    rin = _check_axis(e_a, delta, v, A, rows, build.TILE_ROWS, wrap, mode,
                      front)
    cin = _check_axis(e_b, delta, u, B, cols, build.TILE_COLS, wrap, mode,
                      front)
    # The slice range: a tile-slice with a sample in the box is active.
    rt = torch.arange(v.shape[0]) // build.TILE_ROWS
    ct = torch.arange(u.shape[0]) // build.TILE_COLS
    active = front[None, None, :] & rows[2][:, None, :] & cols[2][None, :, :]
    sample = rin[:, None, :] & cin[None, :, :]
    assert bool((active[rt][:, ct] | ~sample).all())
    assert bool(sample.any())
    # The stage holds every active window; the tally's host mirror.
    r_ext, c_ext = rows[1] - rows[0] + 1, cols[1] - cols[0] + 1
    area = r_ext[:, None, :] * c_ext[None, :, :]
    need = build.stage_texels(spans)
    assert need == int(area[active].max())
    n_active = int(active.sum())
    assert build.tile_slices(spans, need) == (n_active, 0)
    assert build.tile_slices(spans, 0) == (n_active, n_active)
    half = build.tile_slices(spans, need // 2)
    assert half == (n_active, int((area[active] > need // 2).sum()))
    return need


@pytest.mark.parametrize("mode", ["mirror", "clamp", "wrap"])
@pytest.mark.parametrize("eye", EYES)
def test_samples_lie_in_their_tile_windows(eye, mode):
    _check_plan(*_inputs(eye, mode), mode)


@pytest.mark.parametrize("case", [
    dict(eye=EYES[0], n_slices=24),
    dict(eye=EYES[4], n_slices=11, mode="wrap"),
    dict(eye=EYES[1], force=(100, 70)),
    dict(eye=EYES[2], force=(70, 100), mode="clamp"),
    dict(eye=EYES[3], force=(33, 95), mode="wrap"),
    dict(eye=EYES[3], shape=(64, 64, 64), width=128, height=128),
    dict(eye=EYES[2], shape=(64, 64, 64), force=(37, 45), mode="wrap"),
    dict(eye=(0.9, 0.8, 1.6), shape=(15, 17, 13), mode="wrap"),
], ids=["sub-voxel", "sub-voxel wrap", "ragged", "ragged clamp",
        "ragged wrap", "64^3 on 128^2", "64^3 on 37x45 wrap",
        "near eye odd shape"])
def test_samples_lie_in_their_tile_windows_edge_plans(case):
    mode = case.get("mode", "mirror")
    _check_plan(*_inputs(**case), mode)


def test_texel_dense_plan_needs_a_larger_stage():
    """A base pixel spanning several texels widens the windows: a 64^3
    grid on a 37 x 45 base needs a larger stage than on its natural base."""
    fine = _check_plan(*_inputs(EYES[3], shape=(64, 64, 64)), "mirror")
    coarse = _check_plan(*_inputs(EYES[3], shape=(64, 64, 64),
                                  force=(37, 45)), "mirror")
    assert coarse > 4 * fine


def test_stage_cap_bounds_the_shared_memory():
    """stage_cap keeps a launch's windows within STAGE_BYTES_MAX."""
    most = build.STAGE_BYTES_MAX // 4
    assert [build.stage_buffers(bwd, light) for bwd in (False, True)
            for light in (False, True)] == [2, 4, 2, 4]
    for buffers in (2, 4):
        assert build.stage_cap(10 ** 9, buffers) * 4 * buffers \
            <= build.STAGE_BYTES_MAX
        assert build.stage_cap(most // buffers, buffers) == most // buffers
        assert build.stage_cap(7, buffers) == 7
    assert build.stage_cap(0, 2) == 0


@pytest.mark.parametrize("light", [False, True])
def test_k2_layout_fits_the_stage_bytes(light):
    """K2 stages as K1 does, two windows a volume (its sums go straight to
    global memory), and config 5's stage of 1,156 texels fits whole within
    STAGE_BYTES_MAX."""
    buffers = build.stage_buffers(True, light)
    assert buffers == build.stage_buffers(False, light) == (4 if light
                                                            else 2)
    assert build.stage_cap(1156, buffers) == 1156
    assert 4 * buffers * 1156 <= build.STAGE_BYTES_MAX


def test_stage_for_is_sized_once_per_plan():
    """stage_for computes once per set of plan tensors, and the params the
    sweep builds for a plan are one tensor per plan and values."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    plan = plan_sweep(make_camera(CameraConfig(eye=EYES[3], width=96,
                                               height=64)),
                      (16, 16, 16), cfg)
    gperm = torch.zeros(16, 16, 16).permute(plan.perm)
    (_, slice_z, v, u, _, params), _ = sweep_fwd.sweep_inputs(
        gperm, plan, cfg, MEDIUM, LightConfig())
    (_, *_, again), _ = sweep_fwd.sweep_inputs(gperm, plan, cfg, MEDIUM,
                                               LightConfig())
    assert again is params
    (_, *_, other), _ = sweep_fwd.sweep_inputs(
        gperm, plan, cfg, MediumConfig(combine="single", density=4.0),
        LightConfig())
    assert other is not params and float(other[4]) == 4.0
    calls = []
    real = build.stage_texels

    def counted(spans):
        calls.append(1)
        return real(spans)
    build.stage_texels = counted
    try:
        first = build.stage_for(slice_z, v, u, params, 16, 16, False)
        assert build.stage_for(slice_z, v, u, params, 16, 16, False) == first
        assert len(calls) == 1
        build.stage_for(slice_z, v.clone(), u, params, 16, 16, False)
        assert len(calls) == 2
    finally:
        build.stage_texels = real
    assert first == real(build.tile_spans(slice_z, v, u, params, 16, 16,
                                          False))


def test_identity_cache_forgets_freed_tensors():
    """A freed tensor's reused id never returns its value."""
    cache = build.IdentityCache(size=2)
    a = torch.zeros(3)
    assert cache.get((a,), 1, lambda: "a") == "a"
    assert cache.get((a,), 1, lambda: "again") == "a"
    assert cache.get((a,), 2, lambda: "a2") == "a2"
    ref = next(iter(cache._entries.values()))[0][0]
    del a
    assert ref() is None
    b = torch.zeros(3)
    assert cache.get((b,), 1, lambda: "b") == "b"
    assert len(cache._entries) <= 2
