"""The hand-written CUDA sweep kernels (forward and backward, of the
single-channel medium and of the 4-channel reference medium) against their
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
from volumetricrenderer_tpu_torch.kernels import sweep_bwd, sweep_fwd, \
    sweep_ref_bwd, sweep_ref_fwd
from volumetricrenderer_tpu_torch.ops.integrate import reference_media_scroll

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


# --- the 4-channel reference-combine kernels ------------------------------

def _scroll(kind, dev):
    """none; the preset's own scroll (whose weighted offsets are all zero);
    a seeded (4, 3) scroll in [-1.5, 1.5], whose offsets are not."""
    if kind == "none":
        return None
    if kind == "preset":
        return reference_media_scroll(1.7, device=dev)
    return torch.tensor(np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)),
                        dtype=torch.float32, device=dev)


def _ref_setup(dev, eye, emission, scroll="random", n_slices=None,
               density=1.0, d=16):
    grid = torch.tensor(
        np.random.default_rng(0).uniform(0.1, 1.0, (d, d, d, 4)),
        dtype=torch.float32, device=dev)
    cfg = RenderConfig(emission=emission, quadrature="sliced")
    plan = plan_for(make_camera(CameraConfig(eye=eye, width=96, height=64)),
                    grid.shape, cfg, n_slices=n_slices, device=dev)
    medium = MediumConfig(combine="reference", density=density)
    inputs = sweep_ref_fwd.sweep_ref_inputs(
        grid.permute(plan.perm + (3,)), plan, cfg, medium, None,
        _scroll(scroll, dev))
    return grid, cfg, plan, medium, inputs


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("emission", [True, False])
@pytest.mark.parametrize("scroll", ["none", "preset", "random"])
def test_ref_kernels_match_plain_versions(cuda, eye, axis, sign, emission,
                                          scroll):
    """K4 against sweep_ref_fwd_reference and K5 against
    sweep_ref_bwd_reference, on the kernel forward's maps and seeded normal
    cotangents."""
    _, _, plan, _, inputs = _ref_setup(cuda, eye, emission, scroll)
    assert (plan.axis, plan.sign) == (axis, sign)
    before = (sweep_ref_fwd.launches, sweep_ref_bwd.launches)
    maps = sweep_ref_fwd.launch_kernel(*inputs, emission)
    want = sweep_ref_fwd.sweep_ref_fwd_reference(*inputs, emission=emission)
    for g, w, n in zip(maps, want, NAMES):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=cuda) for _ in range(3)]
    got = sweep_ref_bwd.launch_kernel(*inputs, *cts, maps[1], maps[2],
                                      emission=emission)
    torch.cuda.synchronize()
    assert (sweep_ref_fwd.launches, sweep_ref_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    _assert_grad_close(got, sweep_ref_bwd.sweep_ref_bwd_reference(
        *inputs, *cts, maps[1], maps[2], emission=emission))


@pytest.mark.gpu
@pytest.mark.parametrize("emission", [True, False])
def test_ref_kernels_sub_voxel(cuda, emission):
    _, _, plan, _, inputs = _ref_setup(cuda, EYES[0][0], emission,
                                       n_slices=24)
    assert inputs[0].shape == (24, 4, 16, 16)
    maps = sweep_ref_fwd.launch_kernel(*inputs, emission)
    want = sweep_ref_fwd.sweep_ref_fwd_reference(*inputs, emission=emission)
    for g, w, n in zip(maps, want, NAMES):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)


@pytest.mark.gpu
def test_ref_backward_kernel_early_stop_gate(cuda):
    """density 500: rays go opaque within a few slices, so a replay that
    rounded T differently would stop at another slice."""
    _, _, plan, _, inputs = _ref_setup(cuda, EYES[0][0], True, density=500.0)
    maps = sweep_ref_fwd.launch_kernel(*inputs, True)
    assert float(maps[1].min()) < 1e-3
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=cuda) for _ in range(3)]
    got = sweep_ref_bwd.launch_kernel(*inputs, *cts, maps[1], maps[2],
                                      emission=True)
    _assert_grad_close(got, sweep_ref_bwd.sweep_ref_bwd_reference(
        *inputs, *cts, maps[1], maps[2], emission=True), tol=5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("emission", [True, False])
def test_gpu_ref_render_and_gradient_match_cpu(cuda, emission):
    """render_image with the 4-channel grid and a scroll on the card (K4,
    K5, the L build) against the same on the CPU (the plain versions):
    image and d/dgrid of sum(rgb^2)."""
    from volumetricrenderer_tpu_torch import render_image
    grid_c = torch.tensor(
        np.random.default_rng(1).uniform(0.1, 1.0, (24, 24, 24, 4)),
        dtype=torch.float32)
    cam = make_camera(CameraConfig(width=96, height=64))
    cfg = RenderConfig(emission=emission, quadrature="sliced")
    medium = MediumConfig(combine="reference", density=4.0)
    imgs, grads = [], []
    for g in (grid_c.to(cuda), grid_c.clone()):
        g.requires_grad_()
        img = render_image(g, cam, cfg, medium,
                           scroll=_scroll("random", g.device))
        (img[..., :3] ** 2).sum().backward()
        imgs.append(img.detach().cpu())
        grads.append(g.grad.cpu())
    torch.testing.assert_close(imgs[0], imgs[1], rtol=RTOL, atol=1e-4)
    _assert_grad_close(*grads)


@pytest.mark.gpu
def test_cuda_ref_path_never_runs_plain_versions(cuda, monkeypatch):
    """On a CUDA grid the reference-combine forward and backward launch
    K4 and K5, once each, and never reach the plain versions."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the CUDA path")
    monkeypatch.setattr(sweep_ref_fwd, "sweep_ref_fwd_reference", refuse)
    monkeypatch.setattr(sweep_ref_bwd, "sweep_ref_bwd_reference", refuse)
    grid, cfg, plan, medium, _ = _ref_setup(cuda, EYES[3][0], True)
    g = grid.clone().requires_grad_()
    before = (sweep_ref_fwd.launches, sweep_ref_bwd.launches)
    maps = sweep_ref_fwd.sweep_base_ref(g.permute(plan.perm + (3,)), plan,
                                        cfg, medium, None,
                                        _scroll("random", cuda))
    (maps[1].sum() + (maps[2] ** 2).sum()).backward()
    torch.cuda.synchronize()
    assert (sweep_ref_fwd.launches, sweep_ref_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(g.grad).all())
    for c in range(4):
        assert float(g.grad[..., c].abs().max()) > 0


@pytest.mark.gpu
def test_ref_launches_validate_inputs(cuda):
    _, _, plan, _, inputs = _ref_setup(cuda, EYES[0][0], True)
    L, *args = inputs
    maps = torch.zeros((3,) + plan.base_shape, device=cuda)
    before = (sweep_ref_fwd.launches, sweep_ref_bwd.launches)
    with pytest.raises(ValueError, match="contiguous"):
        sweep_ref_fwd.launch_kernel(L.transpose(2, 3), *args, True)
    with pytest.raises(ValueError, match="stack must be"):
        sweep_ref_fwd.launch_kernel(L[:, 0].contiguous(), *args, True)
    with pytest.raises(ValueError, match="params"):
        sweep_ref_fwd.launch_kernel(L, *args[:4], args[4][:8].contiguous(),
                                    True)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_ref_fwd.launch_kernel(L.cpu(), *args, True)
    with pytest.raises(ValueError, match="ct_wsum"):
        sweep_ref_bwd.launch_kernel(L, *args, maps[0], maps[1], maps[2][:-1],
                                    maps[1], maps[2], emission=True)
    with pytest.raises(ValueError, match="ct_acc"):
        sweep_ref_bwd.launch_kernel(L, *args, None, None, None, None, None,
                                    emission=False)
    assert (sweep_ref_fwd.launches, sweep_ref_bwd.launches) == before
