"""The hand-written CUDA sweep kernels (forward and backward) against their
plain PyTorch versions on the card. Every test here needs a CUDA GPU and
skips without one (a CUDA kernel has no CPU mode). The file imports no
JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance rtol=2e-4, atol=2e-5, as tests/test_sweep_pallas.py holds the
Pallas kernels to the jnp sweep: kernel and plain version take the same
front-to-back order per pixel, so they differ by the order of the bilinear
tap sum and expf's last bit.
"""
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu_torch import CameraConfig, MediumConfig, \
    RenderConfig, make_camera, plan_for
from volumetricrenderer_tpu_torch.kernels import sweep_bwd, sweep_fwd

RTOL, ATOL = 2e-4, 2e-5
# The backward kernel adds its taps with atomics, in another order on every
# run: held to rtol=2e-4, atol=2e-4 * max|dG|, as tests/test_sweep_pallas.py
# holds K2 to the jnp sweep (5e-4 in the early-stop case).
BWD_TOL = 2e-4
NAMES = ("acc", "trans", "wsum", "hit")

EYES = [
    ((3.0, 0.4, 0.3), 0, -1),
    ((-3.0, 0.4, 0.3), 0, 1),
    ((0.3, 3.0, 0.4), 1, -1),
    ((0.4, 0.3, 3.0), 2, -1),
    ((0.4, 0.3, -3.0), 2, 1),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sweep kernel has no CPU mode")
    return torch.device("cuda", 0)


def _setup(dev, eye, emission, mode="mirror", n_slices=None, d=16):
    grid = torch.tensor(np.random.default_rng(0).uniform(0.2, 1.0, (d,) * 3),
                        dtype=torch.float32, device=dev)
    cfg = RenderConfig(emission=emission, quadrature="sliced",
                       address_mode=mode)
    plan = plan_for(make_camera(CameraConfig(eye=eye, width=96, height=64)),
                    grid.shape, cfg, n_slices=n_slices, device=dev)
    return grid, cfg, plan, MediumConfig(combine="single", density=8.0)


def _check(grid, cfg, plan, medium):
    gperm = grid.permute(plan.perm)
    before = sweep_fwd.launches
    got = sweep_fwd.sweep_base(gperm, plan, cfg, medium)
    torch.cuda.synchronize()
    assert sweep_fwd.launches == before + 1
    inputs, flip = sweep_fwd.sweep_inputs(gperm, plan, cfg, medium)
    want = sweep_fwd.sweep_fwd_reference(*inputs, emission=cfg.emission,
                                         flip=flip,
                                         address_mode=cfg.address_mode)
    for g, w, n in zip(got, want, NAMES):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("emission", [True, False])
@pytest.mark.parametrize("mode", ["mirror", "clamp", "wrap"])
def test_kernel_matches_plain_version(cuda, eye, axis, sign, emission, mode):
    grid, cfg, plan, medium = _setup(cuda, eye, emission, mode)
    assert (plan.axis, plan.sign) == (axis, sign)
    _check(grid, cfg, plan, medium)


@pytest.mark.gpu
@pytest.mark.parametrize("emission", [True, False])
def test_kernel_matches_plain_version_sub_voxel(cuda, emission):
    grid, cfg, plan, medium = _setup(cuda, EYES[0][0], emission, n_slices=24)
    _check(grid, cfg, plan, medium)


@pytest.mark.gpu
def test_kernel_render_matches_plain_render(cuda):
    """A whole frame through render_image on the card against the same
    frame rendered on the CPU (plain version, same plan values)."""
    from volumetricrenderer_tpu_torch import cloud_volume, render_image
    grid_c = cloud_volume(32, 7)
    cam = make_camera(CameraConfig(width=96, height=64))
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    got = render_image(grid_c.to(cuda), cam, cfg, medium).cpu()
    want = render_image(grid_c, cam, cfg, medium)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-4)


def _bwd_case(dev, eye, emission, mode="mirror", n_slices=None,
              density=8.0):
    """K2 and its plain version on the same inputs: the kernel forward's
    trans and wsum maps and seeded normal cotangents."""
    grid, cfg, plan, medium = _setup(dev, eye, emission, mode, n_slices)
    medium = MediumConfig(combine="single", density=density)
    (stack, *args), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium)
    stack = stack.contiguous()
    maps = sweep_fwd.launch_kernel(stack, *args, emission, flip,
                                   mode == "wrap")
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    before = sweep_bwd.launches
    got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2],
                                  emission, flip, mode == "wrap")
    torch.cuda.synchronize()
    assert sweep_bwd.launches == before + 1
    want = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1],
                                         maps[2], emission=emission,
                                         flip=flip, address_mode=mode)
    return got, want


def _assert_grad_close(got, want, tol=BWD_TOL):
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("emission", [True, False])
@pytest.mark.parametrize("mode", ["mirror", "clamp", "wrap"])
def test_backward_kernel_matches_plain_version(cuda, eye, axis, sign,
                                               emission, mode):
    _assert_grad_close(*_bwd_case(cuda, eye, emission, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("emission", [True, False])
def test_backward_kernel_matches_plain_version_sub_voxel(cuda, emission):
    _assert_grad_close(*_bwd_case(cuda, EYES[0][0], emission, n_slices=24))


@pytest.mark.gpu
def test_backward_kernel_early_stop_gate(cuda):
    _assert_grad_close(*_bwd_case(cuda, EYES[0][0], True, density=500.0),
                       tol=5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("emission", [True, False])
def test_gpu_render_gradient_matches_cpu(cuda, emission):
    """d/dgrid of sum(rgb^2) through render_image on the card (both
    kernels) against the same on the CPU (both plain versions)."""
    from volumetricrenderer_tpu_torch import cloud_volume, render_image
    grid_c = cloud_volume(32, 7)
    cam = make_camera(CameraConfig(width=96, height=64))
    cfg = RenderConfig(emission=emission, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    grads = []
    for g in (grid_c.to(cuda), grid_c.clone()):
        g.requires_grad_()
        (render_image(g, cam, cfg, medium)[..., :3] ** 2).sum().backward()
        grads.append(g.grad.cpu())
    _assert_grad_close(*grads)


@pytest.mark.gpu
def test_cuda_backward_never_runs_plain_version(cuda, monkeypatch):
    """On a CUDA grid the forward and backward launch the kernels, once
    each, and never reach the plain versions."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the CUDA path")
    monkeypatch.setattr(sweep_fwd, "sweep_fwd_reference", refuse)
    monkeypatch.setattr(sweep_bwd, "sweep_bwd_reference", refuse)
    grid, cfg, plan, medium = _setup(cuda, EYES[3][0], True)
    g = grid.clone().requires_grad_()
    before = (sweep_fwd.launches, sweep_bwd.launches)
    maps = sweep_fwd.sweep_base(g.permute(plan.perm), plan, cfg, medium)
    (maps[1].sum() + maps[2].sum()).backward()
    torch.cuda.synchronize()
    assert (sweep_fwd.launches, sweep_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert bool(torch.isfinite(g.grad).all()) and float(g.grad.abs().max()) > 0


@pytest.mark.gpu
def test_backward_launch_validates_inputs(cuda):
    grid, cfg, plan, medium = _setup(cuda, EYES[0][0], True)
    (stack, *args), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium)
    maps = torch.zeros((3,) + plan.base_shape, device=cuda)
    before = sweep_bwd.launches
    with pytest.raises(ValueError, match="contiguous"):  # a permuted view
        sweep_bwd.launch_kernel(stack, *args, *maps, maps[1], maps[2], True,
                                flip, False)
    with pytest.raises(ValueError, match="ct_wsum"):
        sweep_bwd.launch_kernel(stack.contiguous(), *args, maps[0], maps[1],
                                maps[2][:-1], maps[1], maps[2], True, flip,
                                False)
    with pytest.raises(ValueError, match="ct_acc"):
        sweep_bwd.launch_kernel(stack.contiguous(), *args, None, None, None,
                                None, None, False, flip, False)
    assert sweep_bwd.launches == before


@pytest.mark.gpu
def test_kernel_launch_validates_inputs(cuda):
    grid, cfg, plan, medium = _setup(cuda, EYES[0][0], True)
    (stack, *args), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium)
    before = sweep_fwd.launches
    with pytest.raises(ValueError, match="contiguous"):  # a permuted view
        sweep_fwd.launch_kernel(stack, *args, True, flip, False)
    with pytest.raises(ValueError, match="float32"):
        sweep_fwd.launch_kernel(stack.contiguous().double(), *args, True,
                                flip, False)
    with pytest.raises(ValueError, match="seglen"):
        sweep_fwd.launch_kernel(stack.contiguous(), *args[:3],
                                args[3][:-1].contiguous(), args[4], True,
                                flip, False)
    assert sweep_fwd.launches == before
