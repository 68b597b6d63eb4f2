"""volumetricrenderer_tpu_torch — the PyTorch and CUDA port of
volumetricrenderer_tpu, for NVIDIA Hopper GPUs.

The JAX package beside it stays the reference: every module here has a
counterpart there under the same relative path, and the tests
(tests/test_torch_*.py) run both on the same inputs. Ported so far: the
forward render (configs, noise, the FBM cloud and the reference preset's
4-channel volume, cameras, the sweep plan, the screen warp, render_image,
PNG output), the training path (fit_grid, the per-ray oracle), the
slice sweep as four hand-written CUDA kernels, each with its plain PyTorch
version: forward and backward of the single-channel medium and of the
4-channel reference medium, and the shadows of BASELINE config 4 (the
light-transmittance volume and the kernels' light branch), the bfloat16
stream mode of all four kernels (RenderConfig(dtype="bfloat16")), and the
preset front end (render_preset, render_scene, `cli render` and `info`).
This package never imports jax.
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
from .ops.integrate import reference_media_scroll  # noqa: F401
from .ops.lighting import light_transmittance_volume  # noqa: F401
from .ops.media import materialize_sigma  # noqa: F401
from .render import (  # noqa: F401
    plan_for,
    prepare_baked_scene,
    render,
    render_image,
    render_preset,
    render_scene,
)

__version__ = "0.1.0"
