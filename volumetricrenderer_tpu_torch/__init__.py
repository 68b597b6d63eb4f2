"""volumetricrenderer_tpu_torch — the PyTorch and CUDA port of
volumetricrenderer_tpu, for NVIDIA Hopper GPUs.

The JAX package beside it stays the reference: every module here has a
counterpart there under the same relative path, and the tests
(tests/test_torch_*.py) run both on the same inputs. Ported so far: the
forward render (configs, noise and the FBM cloud, cameras, the sweep plan,
the forward slice sweep as a hand-written CUDA kernel with its plain
PyTorch version, the screen warp, render_image, PNG output). This package
never imports jax.
"""

from .config import (  # noqa: F401
    CameraConfig,
    LightConfig,
    MediumConfig,
    NoiseChannelConfig,
    Preset,
    PRESETS,
    RenderConfig,
    VolumeConfig,
    get_preset,
)
from .models.scene import build_volume, cloud_volume  # noqa: F401
from .ops.camera import (  # noqa: F401
    Camera,
    camera_rays,
    look_at_camera,
    make_camera,
    orbit_camera,
)
from .render import plan_for, render, render_image  # noqa: F401

__version__ = "0.1.0"
