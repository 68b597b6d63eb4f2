"""Configuration for the PyTorch port: the same frozen dataclasses, field
names, defaults and presets as volumetricrenderer_tpu/config.py (a test
pins them equal), with `torch_dtype` in place of `jnp_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

ADDRESS_MIRROR = "mirror"
ADDRESS_CLAMP = "clamp"
ADDRESS_WRAP = "wrap"


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera: eye (3,3,3) looking at the origin, up +Z, 45 deg
    vertical fov, 1280x720."""

    eye: Tuple[float, float, float] = (3.0, 3.0, 3.0)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    fov_y_degrees: float = 45.0
    width: int = 1280
    height: int = 720

    @property
    def aspect(self) -> float:
        return self.width / self.height


@dataclasses.dataclass(frozen=True)
class LightConfig:
    """Single directional light."""

    direction: Tuple[float, float, float] = (0.5, 0.5, 1.0)  # towards light
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient: float = 0.1
    shadow_steps: int = 0  # 0 = no shadow march
    shadow_step_size: float = 0.0625


@dataclasses.dataclass(frozen=True)
class MediumConfig:
    """How the grid channels combine into extinction: per-channel
    coordinate scale + scroll offset, then sigma = (s1*s2)*(s3+s4)*scale
    ("reference"), or channel 0 directly ("single")."""

    channel_coord_scale: Tuple[float, float, float, float] = (1.0, 0.8, 0.75, 0.7)
    channel_scroll_weight: Tuple[float, float, float, float] = (0.0, 0.2, 0.25, 0.3)
    sample_scale: float = 0.2
    density: float = 1.0
    combine: str = "reference"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render configuration: box [-1,1]^3, 128 max steps, step
    size 4/128 in box-local units; quadrature "sliced" is the slice sweep
    (ops/sweep.py), "fixed" the per-ray march."""

    max_steps: int = 128
    step_size: float = 4.0 / 128.0
    box_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    box_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    address_mode: str = ADDRESS_MIRROR
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission: bool = False
    early_stop_transmittance: float = 1e-3
    dtype: str = "float32"
    quadrature: str = "fixed"
    sweep_supersample: float = 1.5

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


@dataclasses.dataclass(frozen=True)
class NoiseChannelConfig:
    """One procedural-noise channel."""

    kind: str  # "cellular" | "perlin" | "simplex" | "fbm"
    frequency: float
    seed: int
    octaves: int = 1
    sharpen_power: int = 1


@dataclasses.dataclass(frozen=True)
class VolumeConfig:
    """Procedural volume build recipe: size 128, 4 channels, each min-max
    normalized and inverted, channel 0 sharpened by pow4."""

    size: int = 128
    channels: Tuple[NoiseChannelConfig, ...] = (
        NoiseChannelConfig("cellular", 0.01, 1, sharpen_power=4),
        NoiseChannelConfig("cellular", 0.03, 2),
        NoiseChannelConfig("perlin", 0.19, 3),
        NoiseChannelConfig("simplex", 0.15, 4),
    )
    quantize_uint8: bool = False


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    volume: VolumeConfig
    camera: CameraConfig
    render: RenderConfig
    medium: MediumConfig
    light: LightConfig
    scene: str = ""


def _perlin_volume(size: int, seed: int = 3) -> VolumeConfig:
    return VolumeConfig(
        size=size,
        channels=(NoiseChannelConfig("perlin", 0.08, seed),),
    )


def _fbm_cloud(size: int, seed: int = 7) -> VolumeConfig:
    return VolumeConfig(
        size=size,
        channels=(NoiseChannelConfig("fbm", 4.0 / size, seed, octaves=5),),
    )


PRESETS = {
    "config1": Preset(
        name="config1",
        volume=_perlin_volume(64),
        camera=CameraConfig(width=256, height=256),
        render=RenderConfig(quadrature="sliced"),
        medium=MediumConfig(combine="single"),
        light=LightConfig(),
    ),
    "config2": Preset(
        name="config2",
        volume=_fbm_cloud(128),
        camera=CameraConfig(width=512, height=512),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(),
    ),
    "config3": Preset(
        name="config3",
        volume=_fbm_cloud(256),
        camera=CameraConfig(width=1024, height=1024),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(),
        scene="config3_scene",
    ),
    "config4": Preset(
        name="config4",
        volume=_fbm_cloud(256),
        camera=CameraConfig(width=1920, height=1080),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(shadow_steps=32),
    ),
    "config5": Preset(
        name="config5",
        volume=_fbm_cloud(512),
        camera=CameraConfig(width=1920, height=1080),
        render=RenderConfig(emission=True, quadrature="sliced"),
        medium=MediumConfig(combine="single", density=8.0),
        light=LightConfig(),
    ),
    "reference": Preset(
        name="reference",
        volume=VolumeConfig(),
        camera=CameraConfig(),
        render=RenderConfig(),
        medium=MediumConfig(),
        light=LightConfig(),
    ),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
