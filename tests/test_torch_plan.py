"""The PyTorch port's sweep plan against the JAX plan, each built from its
own package's camera: the same axis, sign, permutation and base grid, and
plan arrays within atol 1e-6. The host geometry is the same float64 numpy
in both; the per-pixel maps are float32 on the device in both, where the
two libraries' atan and sqrt may differ in the last bit (~3e-7 in the warp
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
