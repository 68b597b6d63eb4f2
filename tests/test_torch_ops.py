"""Leaf ops of the PyTorch port against the JAX package on the same
inputs: address modes, banded resample matrices, cameras, the screen warp,
the post-warp pixel transform and PNG output."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu.config import CameraConfig as JCameraConfig
from volumetricrenderer_tpu.config import MediumConfig as JMedium
from volumetricrenderer_tpu.config import RenderConfig as JRender
from volumetricrenderer_tpu.ops import camera as jcam
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu.ops.resample import \
    linear_resample_matrix as j_lrm
from volumetricrenderer_tpu.ops.sampling import \
    apply_address_mode as j_address
from volumetricrenderer_tpu.utils import image as jimage
from volumetricrenderer_tpu_torch.config import CameraConfig, MediumConfig, \
    RenderConfig
from volumetricrenderer_tpu_torch.ops import camera as tcam
from volumetricrenderer_tpu_torch.ops import sweep as tsweep
from volumetricrenderer_tpu_torch.ops.resample import linear_resample_matrix
from volumetricrenderer_tpu_torch.ops.sampling import apply_address_mode
from volumetricrenderer_tpu_torch.utils import image as timage

torch.set_num_threads(1)

MODES = ["mirror", "clamp", "wrap"]


@pytest.mark.parametrize("mode", MODES)
def test_apply_address_mode(mode):
    idx = np.arange(-40, 41, dtype=np.int32)
    want = np.asarray(j_address(jnp.asarray(idx), 7, mode))
    got = apply_address_mode(torch.from_numpy(idx).long(), 7, mode)
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_address_mode_rejects_unknown():
    with pytest.raises(ValueError):
        apply_address_mode(torch.arange(3), 3, "border")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("zero_outside", [False, True])
def test_linear_resample_matrix(mode, zero_outside):
    u01 = np.random.default_rng(1).uniform(-0.3, 1.3, 200).astype(np.float32)
    u01[:4] = [0.0, 1.0, 0.5 / 16, 1.0 - 0.5 / 16]
    want = np.asarray(j_lrm(jnp.asarray(u01), 16, mode,
                            zero_outside=zero_outside))
    got = linear_resample_matrix(torch.from_numpy(u01), 16, mode,
                                 zero_outside=zero_outside)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


CAMS = [dict(), dict(eye=(0.4, 0.3, -3.0), width=96, height=64),
        dict(eye=(-2.0, 1.5, 0.7), fov_y_degrees=60.0, width=33, height=17)]


@pytest.mark.parametrize("kw", CAMS)
def test_make_camera_and_rays(kw):
    j = jcam.make_camera(JCameraConfig(**kw))
    t = tcam.make_camera(CameraConfig(**kw))
    for f in ("eye", "right", "up", "forward", "tan_half_fov"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert (t.aspect, t.width, t.height) == (j.aspect, j.width, j.height)
    for a, b in zip(tcam.camera_rays(t), jcam.camera_rays(j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("t", [0.0, 0.7853981, 2.5, -1.2])
def test_orbit_camera(t):
    j = jcam.orbit_camera(t, width=64, height=48)
    c = tcam.orbit_camera(t, width=64, height=48)
    for f in ("eye", "right", "up", "forward", "tan_half_fov"):
        np.testing.assert_allclose(getattr(c, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=2e-6, err_msg=f)


def _plans(emission=True, eye=(3.0, 3.0, 3.0)):
    jcfg = JRender(emission=emission, quadrature="sliced")
    jplan = jsweep.plan_sweep(
        jcam.make_camera(JCameraConfig(eye=eye, width=96, height=64)),
        (16, 16, 16), jcfg)
    tcfg = RenderConfig(emission=emission, quadrature="sliced")
    tplan = tsweep.plan_sweep(
        tcam.make_camera(CameraConfig(eye=eye, width=96, height=64)),
        (16, 16, 16), tcfg)
    # The warp is compared on the JAX plan's own pixel coords: the two
    # plans' coords differ by float32 atan rounding (test_torch_plan.py).
    tplan = dataclasses.replace(
        tplan, warp_rows01=torch.from_numpy(np.array(jplan.warp_rows01)),
        warp_cols01=torch.from_numpy(np.array(jplan.warp_cols01)))
    return jcfg, jplan, tcfg, tplan


def test_warp_base_to_pixels():
    """A single-channel map with a scalar miss value; the two-channel warp
    runs in test_finish_image."""
    _, jplan, _, tplan = _plans(eye=(0.4, 0.3, -3.0))
    base = np.random.default_rng(2).uniform(0, 1, jplan.base_shape) \
        .astype(np.float32)
    miss = 0.5
    want = np.asarray(jsweep.warp_base_to_pixels(jnp.asarray(base), jplan,
                                                 miss=miss))
    got = tsweep.warp_base_to_pixels(torch.from_numpy(base), tplan,
                                     miss=miss)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # identity_warp hands the base maps back unchanged
    ident = dataclasses.replace(tplan, identity_warp=True)
    tbase = torch.from_numpy(base)
    assert tsweep.warp_base_to_pixels(tbase, ident) is tbase


@pytest.mark.parametrize("emission", [True, False])
def test_finish_image(emission):
    jcfg, jplan, tcfg, tplan = _plans(emission=emission)
    Hb, Wb = jplan.base_shape
    rng = np.random.default_rng(4)
    maps = [rng.uniform(0, 1, (Hb, Wb)).astype(np.float32) for _ in range(4)]
    jmed = JMedium(combine="single", density=8.0)
    tmed = MediumConfig(combine="single", density=8.0)
    want = np.asarray(jsweep.finish_image(tuple(map(jnp.asarray, maps)),
                                          jplan, jcfg, jmed))
    got = tsweep.finish_image(tuple(map(torch.from_numpy, maps)), tplan,
                              tcfg, tmed)
    assert got.shape == want.shape == (64, 96, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_image_encoding_matches():
    img = np.random.default_rng(5).uniform(-0.1, 1.1, (9, 7, 4)) \
        .astype(np.float32)
    np.testing.assert_array_equal(timage.to_uint8(torch.from_numpy(img)),
                                  jimage.to_uint8(img))
    for arr in (img, img[..., :3], img[..., 0]):
        assert timage.encode_png(torch.from_numpy(
            np.ascontiguousarray(arr))) == jimage.encode_png(arr)


def test_write_png(tmp_path):
    img = torch.rand(5, 6, 4, generator=torch.Generator().manual_seed(0))
    path = timage.write_png(tmp_path / "f.png", img)
    assert path.read_bytes() == jimage.encode_png(img.numpy())
