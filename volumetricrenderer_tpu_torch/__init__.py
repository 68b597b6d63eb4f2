"""volumetricrenderer_tpu_torch — the PyTorch and CUDA port of
volumetricrenderer_tpu, for NVIDIA Hopper GPUs.

The JAX package beside it stays the reference: every module here has a
counterpart there under the same relative path, and the tests
(tests/test_torch_*.py) run both on the same inputs. The port does all
that the JAX package does: the forward render and its training path
(configs, noise, volumes and scenes, cameras, the sweep plan, the screen
warp, render_image, fit_grid, the per-ray oracle), the slice sweep as four
hand-written CUDA kernels, each with its plain PyTorch version (forward
and backward of the single-channel medium and of the 4-channel reference
medium, with BASELINE config 4's light volume, in float32 and in the
bfloat16 stream mode), the general PyTorch sweep for what no kernel covers,
the preset and viewer front ends (render_preset, render_scene, serve,
`cli render | fit | info | serve | animate`), and the slab-sharded sweep
and train step over torch.distributed (parallel/, BASELINE config 5).
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
from .models.scene import (  # noqa: F401
    Volume,
    build_volume,
    cloud_volume,
    smoke_volume,
    two_volume_grid,
)
from .ops.camera import (  # noqa: F401
    Camera,
    camera_rays,
    look_at_camera,
    make_camera,
    orbit_camera,
)
from .ops.integrate import (  # noqa: F401
    reference_media_scroll,
    render_rays,
    transform_rays,
)
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
