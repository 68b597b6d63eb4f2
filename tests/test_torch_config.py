"""The PyTorch port's config dataclasses and presets equal the JAX
package's field for field, so the two cannot drift."""
import dataclasses

import pytest
import torch

import volumetricrenderer_tpu.config as jc
import volumetricrenderer_tpu_torch.config as tc

CLASSES = ["CameraConfig", "LightConfig", "MediumConfig", "RenderConfig",
           "NoiseChannelConfig", "VolumeConfig", "Preset"]


def _spec(cls):
    # repr: a default may hold the package's own dataclass instances
    return [(f.name, repr(f.default), f.default_factory)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    j, t = getattr(jc, name), getattr(tc, name)
    assert _spec(t) == _spec(j)
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen


@pytest.mark.parametrize("name", sorted(jc.PRESETS))
def test_presets_match(name):
    assert dataclasses.asdict(tc.get_preset(name)) == \
        dataclasses.asdict(jc.get_preset(name))


def test_preset_names_and_constants_match():
    assert sorted(tc.PRESETS) == sorted(jc.PRESETS)
    assert (tc.ADDRESS_MIRROR, tc.ADDRESS_CLAMP, tc.ADDRESS_WRAP) == \
        (jc.ADDRESS_MIRROR, jc.ADDRESS_CLAMP, jc.ADDRESS_WRAP)
    with pytest.raises(KeyError):
        tc.get_preset("no-such-preset")
    assert tc.CameraConfig(width=1920, height=1080).aspect == \
        jc.CameraConfig(width=1920, height=1080).aspect


@pytest.mark.parametrize("dtype,want", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_torch_dtype(dtype, want):
    assert tc.RenderConfig(dtype=dtype).torch_dtype == want
