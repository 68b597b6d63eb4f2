"""The PyTorch port's sweep plan against the JAX plan, each built from its
own package's camera: the same axis, sign, permutation and base grid, and
plan arrays within atol 1e-6. The geometry is the same float64 arithmetic
in both (numpy in the JAX plan, torch on the plan's device in the port);
the per-pixel maps are float32 on the device in both, where the two
libraries' atan and sqrt may differ in the last bit (~3e-7 in the warp
coords)."""
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu.config import CameraConfig as JCameraConfig
from volumetricrenderer_tpu.config import RenderConfig as JRender
from volumetricrenderer_tpu.models.scene import translate_w2l
from volumetricrenderer_tpu.ops import camera as jcam
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu_torch.config import CameraConfig, RenderConfig
from volumetricrenderer_tpu_torch.ops import camera as tcam
from volumetricrenderer_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)

ARRAYS = ("eye01", "v_grid", "u_grid", "slice_z", "seglen", "warp_rows01",
          "warp_cols01", "box_range", "box_min")

# Eyes of tests/test_sweep_pallas.py: sweep axes x/y/z and both signs.
EYES = [
    ((3.0, 0.4, 0.3), 0, -1),
    ((-3.0, 0.4, 0.3), 0, 1),
    ((0.3, 3.0, 0.4), 1, -1),
    ((0.4, 0.3, 3.0), 2, -1),
    ((0.4, 0.3, -3.0), 2, 1),
]


def _both(cam_kw, grid_shape, emission=True, **plan_kw):
    jplan = jsweep.plan_sweep(jcam.make_camera(JCameraConfig(**cam_kw)),
                              grid_shape, JRender(emission=emission,
                                                  quadrature="sliced"),
                              **plan_kw)
    tplan = tsweep.plan_sweep(tcam.make_camera(CameraConfig(**cam_kw)),
                              grid_shape, RenderConfig(emission=emission,
                                                       quadrature="sliced"),
                              **plan_kw)
    return jplan, tplan


def _assert_plans_match(jplan, tplan):
    for f in ("axis", "sign", "perm", "coord_order", "identity_warp",
              "base_shape"):
        assert tuple(np.atleast_1d(getattr(tplan, f))) == \
            tuple(np.atleast_1d(getattr(jplan, f))), f
    for f in ARRAYS:
        got, want = getattr(tplan, f), np.asarray(getattr(jplan, f))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("eye,axis,sign", EYES)
def test_plan_matches_for_every_axis_and_sign(eye, axis, sign):
    jplan, tplan = _both(dict(eye=eye, width=96, height=64), (16, 16, 16))
    assert (tplan.axis, tplan.sign) == (axis, sign)
    _assert_plans_match(jplan, tplan)


def test_plan_matches_flagship_camera_reduced():
    """The flagship's default camera and 256^3 grid at 384x216 (the
    flagship renders it at 1920x1080)."""
    jplan, tplan = _both(dict(width=384, height=216), (256, 256, 256))
    assert (tplan.axis, tplan.sign, tplan.slice_z.shape[0]) == (2, -1, 256)
    _assert_plans_match(jplan, tplan)


def test_plan_matches_sub_voxel_slicing_and_transform():
    jplan, tplan = _both(dict(eye=(0.3, 3.0, 0.4), width=64, height=48),
                         (16, 16, 16), n_slices=24,
                         world_to_local=np.asarray(translate_w2l(0.1, 0, 0.2)))
    assert tplan.slice_z.shape[0] == 24
    _assert_plans_match(jplan, tplan)


def test_plan_base_dims_match():
    kw = dict(eye=(-2.0, 1.5, 0.7), width=200, height=120)
    cfg_j, cfg_t = JRender(quadrature="sliced"), RenderConfig(
        quadrature="sliced")
    assert tsweep.plan_base_dims(tcam.make_camera(CameraConfig(**kw)),
                                 (32, 32, 32), cfg_t) == \
        jsweep.plan_base_dims(jcam.make_camera(JCameraConfig(**kw)),
                              (32, 32, 32), cfg_j)
    jplan, tplan = _both(kw, (32, 32, 32), force_base_dims=(256, 384))
    assert tplan.base_shape == (256, 384)
    _assert_plans_match(jplan, tplan)


def test_plan_device_argument():
    tplan = tsweep.plan_sweep(
        tcam.make_camera(CameraConfig(width=32, height=16)), (8, 8, 8),
        RenderConfig(quadrature="sliced"), device=torch.device("cpu"))
    assert all(getattr(tplan, f).device.type == "cpu" for f in ARRAYS)


def test_plan_for_defaults_to_the_gpu():
    """plan_for builds its arrays on `device`, "cuda" by default: without a
    GPU the default raises torch's own error, and device="cpu" gives the
    JAX plan on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    from volumetricrenderer_tpu.render import plan_for as jplan_for
    from volumetricrenderer_tpu_torch.render import plan_for
    cam_kw = dict(eye=(0.4, 0.3, 3.0), width=96, height=64)
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = tcam.make_camera(CameraConfig(**cam_kw))
    with pytest.raises((RuntimeError, AssertionError)):
        plan_for(cam, (16, 16, 16), cfg)
    tplan = plan_for(cam, (16, 16, 16), cfg, device="cpu")
    assert tplan.v_grid.device.type == "cpu"
    jplan = jplan_for(jcam.make_camera(JCameraConfig(**cam_kw)), (16, 16, 16),
                      JRender(emission=True, quadrature="sliced"))
    _assert_plans_match(jplan, tplan)


# A camera whose second slope is constant along its one row (column) of
# pixels: every |diff(atan)| of it is filtered out, its spacing falls back
# and its warp coordinate is NaN in both plans.
ALL_FILTERED = [
    dict(eye=(0.0, 0.0, 3.0), center=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0),
         width=9, height=1),
    dict(eye=(0.0, 0.0, 3.0), center=(0.5, 0.0, 0.0), up=(0.0, 1.0, 0.0),
         width=1, height=9),
]


@pytest.mark.parametrize("cam_kw", ALL_FILTERED)
def test_plan_matches_with_every_spacing_filtered(cam_kw):
    jplan, tplan = _both(cam_kw, (16, 16, 16))
    assert tsweep.plan_base_dims(tcam.make_camera(CameraConfig(**cam_kw)),
                                 (16, 16, 16), RenderConfig()) == \
        jsweep.plan_base_dims(jcam.make_camera(JCameraConfig(**cam_kw)),
                              (16, 16, 16), JRender())
    _assert_plans_match(jplan, tplan)


def _lower_middle(a):
    """The lower of an even count's two middle values (torch.median's
    rule); the median of an odd count."""
    return np.sort(a, axis=None)[(a.size - 1) // 2]


def _mean_of_middles(a):
    """The mean of the two values about the middle, as if the count were
    even; np.median's value for an even count only."""
    s = np.sort(a, axis=None)
    return (s[(a.size - 1) // 2] + s[(a.size + 1) // 2]) / 2


@pytest.mark.parametrize("width,wrong", [(9, _lower_middle),
                                         (6, _mean_of_middles)])
def test_plan_takes_np_median_of_even_and_odd_counts(width, wrong):
    """A 1-pixel-high camera has width - 1 angular spacings per slope (8:
    even, 5: odd). At a supersample found where the JAX plan's base dims
    change if its median follows `wrong`, the port's dims and plan equal
    the JAX plan's."""
    cam_kw = dict(eye=(3.0, 0.4, 0.3), width=width, height=1)
    jc = jcam.make_camera(JCameraConfig(**cam_kw))
    tc = tcam.make_camera(CameraConfig(**cam_kw))
    shape, cfg_j, cfg_t = (16, 16, 16), JRender(), RenderConfig()

    def jdims(ss):
        return jsweep.plan_base_dims(jc, shape, cfg_j, supersample=ss)

    def wrong_dims(ss):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(np, "median", wrong)
            return jdims(ss)

    ss = next(s for s in np.arange(4.0, 64.0, 0.25)
              if jdims(s) != wrong_dims(s))
    assert tsweep.plan_base_dims(tc, shape, cfg_t, supersample=ss) == \
        jdims(ss)
    _assert_plans_match(*_both(cam_kw, shape, supersample=ss))


def test_plan_matches_rotated_transform_at_non_square_size():
    """world_to_local with a rotation about z and a translation, at 120x56:
    the rays turn into the volume's frame before the slopes are taken."""
    c, s = np.cos(0.35), np.sin(0.35)
    w2l = np.array([[c, -s, 0.0, 0.1], [s, c, 0.0, -0.05],
                    [0.0, 0.0, 1.0, 0.2], [0.0, 0.0, 0.0, 1.0]])
    jplan, tplan = _both(dict(eye=(0.4, 0.3, 3.0), width=120, height=56),
                         (16, 16, 16), world_to_local=w2l)
    _assert_plans_match(jplan, tplan)


GOLDEN_DEG = 180.0 * (3.0 - np.sqrt(5.0))


def orbit_eye(k):
    """The k-th camera of a golden-angle walk on config 4's orbit (radius
    sqrt(27), height 3, looking at the origin), as new cameras arrive."""
    t = np.radians(k * GOLDEN_DEG)
    return (np.sqrt(18.0) * np.cos(t), np.sqrt(18.0) * np.sin(t), 3.0)


@pytest.mark.parametrize("eye", [(3.0, 3.0, 3.0)]
                         + [orbit_eye(k) for k in range(16)])
def test_geometry_matches_at_1080p(eye):
    """The flagship camera and 16 golden-angle config-4 orbit cameras at
    1920x1080 on a 256^3 grid: the port's float64 geometry on the CPU
    equals the JAX package's numpy geometry, its scalars (axis, sign, base
    dims, the slopes' atan bounds, the eye, the slice set) bit for bit and
    its base-grid slopes (the libraries' tan) within 1e-14 relative.
    tests/test_torch_gpu.py holds the plan built on the card to the one
    built from this geometry on the CPU."""
    kw = dict(eye=tuple(eye), width=1920, height=1080)
    args = ((256, 256, 256),)
    want = jsweep._host_geometry(jcam.make_camera(JCameraConfig(**kw)),
                                 *args, JRender(quadrature="sliced"))
    got = tsweep._host_geometry(tcam.make_camera(CameraConfig(**kw)),
                                *args, RenderConfig(quadrature="sliced"))
    for k in ("axis", "sign", "perm", "coord_order", "Hb", "Wb", "S",
              "thu_lo", "thu_hi", "thv_lo", "thv_hi"):
        assert got[k] == want[k], k
    for k in ("e01_xyz", "slice_z", "box_min", "box_range", "rng_perm"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("u_grid", "v_grid"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-14,
                                   atol=0, err_msg=k)


def test_plan_on_the_cpu_counts_no_device_geometry():
    before = tsweep.device_geometry_calls
    tsweep.plan_sweep(tcam.make_camera(CameraConfig(width=32, height=16)),
                      (8, 8, 8), RenderConfig(quadrature="sliced"),
                      device="cpu")
    assert tsweep.device_geometry_calls == before


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 2.0], [4.0, 1.0, 3.0, 2.0], [2.0, 2.0, 1.0, 5.0],
    [1.0, 2.0, 2.0, 5.0], [7.0, 7.0, 7.0, 7.0], [9.0, np.nan, 1.0, 4.0],
    [np.nan, np.nan], [0.5]])
def test_np_median_of_the_values_not_nan(values):
    """The geometry's median on the device: np.median of the values left
    after the NaNs (which mark filtered spacings), ties included; NaN
    where none is left."""
    x = np.asarray(values)
    kept = x[~np.isnan(x)]
    got = tsweep._np_median(torch.tensor(x)).item()
    want = np.median(kept) if kept.size else np.nan
    assert got == want or (np.isnan(got) and np.isnan(want))
