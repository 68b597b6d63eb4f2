"""Camera model and per-pixel ray generation (port of
volumetricrenderer_tpu/ops/camera.py).

Right-handed look-at (eye (3,3,3), center origin, up +Z by default),
vertical-FOV pinhole projection, image row 0 at the top. A Camera is a few
scalars: the sweep plan reads it on the host, so cameras default to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import CameraConfig

__all__ = ["Camera", "make_camera", "look_at_camera", "camera_rays",
           "orbit_camera"]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Resolved camera: orthonormal basis + tangent, float32 tensors."""

    eye: torch.Tensor        # (3,)
    right: torch.Tensor      # (3,) unit
    up: torch.Tensor         # (3,) unit
    forward: torch.Tensor    # (3,) unit, towards the scene
    tan_half_fov: torch.Tensor  # scalar
    aspect: float
    width: int
    height: int


def make_camera(cfg: CameraConfig, device=None) -> Camera:
    return look_at_camera(cfg.eye, cfg.center, cfg.up, cfg.fov_y_degrees,
                          cfg.width, cfg.height, device=device)


def look_at_camera(eye, center, up, fov_y_degrees, width, height,
                   device=None) -> Camera:
    """Build a Camera from look-at parameters (glm::lookAt semantics)."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    eye = f32(eye)
    forward = f32(center) - eye
    forward = forward / torch.linalg.norm(forward)
    right = torch.linalg.cross(forward, f32(up))
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(right, forward)
    tan_half = torch.tan(torch.deg2rad(f32(fov_y_degrees)) / 2.0)
    return Camera(eye=eye, right=right, up=true_up, forward=forward,
                  tan_half_fov=tan_half, aspect=width / height,
                  width=width, height=height)


def camera_rays(cam: Camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and unit directions, each (H, W, 3), on the
    camera's device. Pixel centers ((i+0.5)/W), row 0 at the top."""
    w, h = cam.width, cam.height
    dev = cam.eye.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    dirs = (px[..., None] * (cam.right * cam.tan_half_fov * cam.aspect)
            + py[..., None] * (cam.up * cam.tan_half_fov)
            + cam.forward)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = torch.broadcast_to(cam.eye, dirs.shape)
    return origins, dirs


def orbit_camera(t, radius=27.0 ** 0.5, height_z=3.0, fov_y_degrees=45.0,
                 width=1920, height=1080, device=None) -> Camera:
    """Orbit path: angle t (radians) around the Z axis at a fixed
    elevation, looking at the origin; t = pi/4 sits at the eye (3,3,3)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    r_xy = torch.sqrt(torch.clamp(
        torch.tensor(radius * radius - height_z * height_z,
                     dtype=torch.float32, device=device), min=1e-6))
    eye = torch.stack([r_xy * torch.cos(t), r_xy * torch.sin(t),
                       torch.tensor(height_z, dtype=torch.float32,
                                    device=device)])
    return look_at_camera(eye, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                          fov_y_degrees, width, height, device=device)
