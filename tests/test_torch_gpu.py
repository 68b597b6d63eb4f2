"""The hand-written CUDA sweep kernels (forward and backward, of the
single-channel medium and of the 4-channel reference medium, without and
with a light volume, in float32 and in the bfloat16 stream mode), the light
sweep's scan and fit_grid's Adam-and-clamp step against their plain
PyTorch versions on the card. Every test here needs a CUDA GPU
and skips without one (a CUDA kernel has no CPU mode). The file imports no
JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance rtol=2e-4, atol=2e-5, as tests/test_sweep_pallas.py holds the
Pallas kernels to the jnp sweep: kernel and plain version take the same
front-to-back order per pixel, so they differ by the order of the bilinear
tap sum and expf's last bit.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from volumetricrenderer_tpu_torch import CameraConfig, LightConfig, \
    MediumConfig, RenderConfig, light_transmittance_volume, make_camera, \
    orbit_camera, plan_for, render_image
from volumetricrenderer_tpu_torch.kernels import sweep_bwd, sweep_fwd, \
    sweep_ref_bwd, sweep_ref_fwd
from volumetricrenderer_tpu_torch.kernels.round_probe import \
    round_weights_on_device
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
    grid_c = cloud_volume(32, 7, device="cpu")
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
    grid_c = cloud_volume(32, 7, device="cpu")
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
    return _seeded_scroll(5, dev)


def _seeded_scroll(seed, dev):
    return torch.tensor(np.random.default_rng(seed).uniform(-1.5, 1.5,
                                                            (4, 3)),
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
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=cuda) for _ in range(3)]
    _assert_grad_close(sweep_ref_bwd.launch_kernel(
        *inputs, *cts, maps[1], maps[2], emission=emission),
        sweep_ref_bwd.sweep_ref_bwd_reference(
            *inputs, *cts, maps[1], maps[2], emission=emission))


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
@pytest.mark.parametrize("emission", [True, False])
@pytest.mark.parametrize("scroll", ["none", "random"])
def test_ref_frame_graphs_replay_the_eager_frame(cuda, monkeypatch,
                                                 emission, scroll):
    """A 4-channel kernel frame without autograd runs eagerly twice per
    grid, plan and configuration and then replays its CUDA graphs
    (ops/sweep.py _RefFrameGraphs): each replayed frame equals the eager
    frame bit for bit, scroll by scroll, and after an in-place change of
    the grid; a replay counts its K4 launch, returns a frame of its own and
    records "sweep.ref_layers" (with its device interval) and
    "sweep.ref_fwd" under clock.tracing(); a frame under autograd stays
    eager."""
    from volumetricrenderer_tpu_torch.ops import sweep
    from volumetricrenderer_tpu_torch.utils import clock
    grid, cfg, plan, medium, _ = _ref_setup(cuda, EYES[0][0], emission)
    cam = make_camera(CameraConfig(eye=EYES[0][0], width=96, height=64))
    scrolls = [None] * 6 if scroll == "none" else \
        [_seeded_scroll(s, cuda) for s in range(6)]

    def eager(sc):
        with monkeypatch.context() as m:
            m.setattr(sweep, "_ref_frame_entry", lambda *a, **kw: None)
            return render_image(grid, cam, cfg, medium, scroll=sc, plan=plan)

    with torch.no_grad():
        want = [eager(sc) for sc in scrolls]
        before = sweep_ref_fwd.launches
        got = [render_image(grid, cam, cfg, medium, scroll=sc, plan=plan)
               for sc in scrolls]
        torch.cuda.synchronize()
        assert sweep_ref_fwd.launches == before + len(scrolls)
        entry = sweep._ref_frame_entry(grid, plan, cfg, medium, None,
                                       scrolls[0], None)
        assert entry.seen == 2 and entry.graphs is not None
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got[-1].data_ptr() != got[-2].data_ptr()
        grid.mul_(0.5)
        assert torch.equal(
            render_image(grid, cam, cfg, medium, scroll=scrolls[1],
                         plan=plan), eager(scrolls[1]))
        clock.clear_spans()
        with clock.tracing():
            render_image(grid, cam, cfg, medium, scroll=scrolls[2],
                         plan=plan)
        names = {s.name: s for s in clock.spans()}
        assert entry.seen == 2
    assert {"render.image", "sweep.ref_layers", "sweep.ref_fwd"} <= set(names)
    assert names["sweep.ref_layers"].device_ns > 0
    g = grid.clone().requires_grad_()
    before = sweep_ref_fwd.launches
    img = render_image(g, cam, cfg, medium, scroll=scrolls[3], plan=plan)
    assert img.requires_grad and sweep_ref_fwd.launches == before + 1
    assert sweep._ref_frame_entry(g, plan, cfg, medium, None, scrolls[3],
                                  None) is None


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


# --- the light branch of the four kernels ---------------------------------

LIGHT = LightConfig(ambient=0.2, shadow_steps=32)


def _light_volume(grid, cfg, medium, kind, scroll=None):
    """The real light volume (exactly 1.0 where fully lit: the clip's tie),
    that volume stretched to [-0.2, 1.3] (all three arms of the clip's
    subgradient), or all ones (shade exactly 1)."""
    lvol = light_transmittance_volume(grid, LIGHT, cfg, medium, scroll=scroll)
    assert float((lvol == 1.0).float().mean()) > 0.02
    if kind == "pushed":
        lo = lvol.min()
        lvol = 1.5 * (lvol - lo) / (1.0 - lo) - 0.2
        assert float(lvol.max()) > 1.0 and float(lvol.min()) < 0.0
    elif kind == "unit":
        lvol = torch.ones_like(lvol)
    return lvol


def _light_case(dev, eye, mode="mirror", n_slices=None, density=8.0,
                kind="ones"):
    """K1 and K2 with a light stack and their plain versions on the same
    inputs. Returns (maps, plain maps, (dG, dL), plain (dG, dL))."""
    grid, cfg, plan, _ = _setup(dev, eye, True, mode, n_slices)
    medium = MediumConfig(combine="single", density=density)
    lvol = _light_volume(grid, cfg, medium, kind)
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        grid.permute(plan.perm), plan, cfg, medium, LIGHT)
    stack = stack.contiguous()
    light = sweep_fwd.sweep_light_stack(lvol.permute(plan.perm), plan,
                                        cfg).contiguous()
    wrap = mode == "wrap"
    before = (sweep_fwd.launches, sweep_bwd.launches)
    maps = sweep_fwd.launch_kernel(stack, *args, True, flip, wrap, light)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2], True,
                                  flip, wrap, light=light)
    torch.cuda.synchronize()
    assert (sweep_fwd.launches, sweep_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    kw = dict(emission=True, flip=flip, address_mode=mode, light=light)
    want_maps = sweep_fwd.sweep_fwd_reference(stack, *args, **kw)
    want = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1],
                                         maps[2], **kw)
    return maps, want_maps, got, want


def _assert_light_case(maps, want_maps, got, want, tol=BWD_TOL, low=False):
    """Maps and gradients against the plain version's; on bfloat16 stacks
    (low) also maps within 1e-6 and, but at the early stop, gradients
    within 1e-5 of their maximum."""
    for g, w, n in zip(maps, want_maps, NAMES):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)
        assert not low or float((g - w).abs().max()) <= 1e-6, n
    for g, w in zip(got, want):  # dG, dL
        _assert_grad_close(g, w, tol)
        assert not low or tol != BWD_TOL or \
            float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("mode", ["mirror", "wrap"])
@pytest.mark.parametrize("kind", ["ones", "pushed"])
def test_light_kernels_match_plain_versions(cuda, eye, axis, sign, mode,
                                            kind):
    _assert_light_case(*_light_case(cuda, eye, mode, kind=kind))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ones", "pushed"])
def test_light_kernels_sub_voxel(cuda, kind):
    _assert_light_case(*_light_case(cuda, EYES[0][0], n_slices=24,
                                    kind=kind))


@pytest.mark.gpu
def test_light_backward_kernel_early_stop_gate(cuda):
    """Density 500 with a light volume: Wr holds the shade, so the replay
    must add the forward's very products or A~ drifts at the last
    slices."""
    maps, want_maps, got, want = _light_case(cuda, EYES[0][0],
                                             density=500.0)
    assert float(maps[1].min()) < 1e-3
    _assert_light_case(maps, want_maps, got, want, tol=5e-4)


def _ref_light_case(dev, eye, kind, n_slices=None, density=8.0):
    grid, cfg, plan, _, _ = _ref_setup(dev, eye, True, n_slices=n_slices)
    medium = MediumConfig(combine="reference", density=density)
    scroll = _scroll("random", dev)
    inputs = sweep_ref_fwd.sweep_ref_inputs(
        grid.permute(plan.perm + (3,)), plan, cfg, medium, LIGHT, scroll)
    lvol = _light_volume(grid, cfg, medium, kind, scroll)
    light = sweep_ref_fwd.sweep_ref_light_slabs(lvol.permute(plan.perm),
                                                plan, cfg)
    before = (sweep_ref_fwd.launches, sweep_ref_bwd.launches)
    maps = sweep_ref_fwd.launch_kernel(*inputs, True, light)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    got = sweep_ref_bwd.launch_kernel(*inputs, *cts, maps[1], maps[2],
                                      emission=True, light=light)
    torch.cuda.synchronize()
    assert (sweep_ref_fwd.launches, sweep_ref_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want_maps = sweep_ref_fwd.sweep_ref_fwd_reference(
        *inputs, emission=True, light=light)
    want = sweep_ref_bwd.sweep_ref_bwd_reference(
        *inputs, *cts, maps[1], maps[2], emission=True, light=light)
    return maps, want_maps, got, want


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("kind", ["ones", "pushed"])
def test_ref_light_kernels_match_plain_versions(cuda, eye, axis, sign, kind):
    """K4 and K5 with light slabs from materialize_sigma's light volume:
    the maps, dL of the channel slabs and dL of the light slabs."""
    _assert_light_case(*_ref_light_case(cuda, eye, kind))


@pytest.mark.gpu
def test_ref_light_kernels_sub_voxel_and_gate(cuda):
    _assert_light_case(*_ref_light_case(cuda, EYES[0][0], "pushed",
                                        n_slices=24))
    maps, want_maps, got, want = _ref_light_case(cuda, EYES[0][0], "ones",
                                                 density=500.0)
    assert float(maps[1].min()) < 1e-3
    _assert_light_case(maps, want_maps, got, want, tol=5e-4)


@pytest.mark.gpu
def test_unit_light_equals_no_light_bit_for_bit(cuda):
    """An all-ones light stack gives shade = ambient + (1 - ambient) = 1.0
    exactly, so the light instantiation of each forward kernel must
    reproduce the no-light instantiation bit for bit: the branch changed
    nothing else in the march."""
    grid, cfg, plan, medium = _setup(cuda, EYES[0][0], True)
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        grid.permute(plan.perm), plan, cfg, medium, LIGHT)
    stack = stack.contiguous()
    ones = torch.ones_like(stack)
    assert torch.equal(
        sweep_fwd.launch_kernel(stack, *args, True, flip, False, ones),
        sweep_fwd.launch_kernel(stack, *args, True, flip, False))
    _, _, _, _, inputs = _ref_setup(cuda, EYES[0][0], True)
    ones = torch.ones_like(inputs[0][:, 0])
    assert torch.equal(sweep_ref_fwd.launch_kernel(*inputs, True, ones),
                       sweep_ref_fwd.launch_kernel(*inputs, True))


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["single", "reference"])
def test_cuda_light_path_never_runs_plain_versions(cuda, monkeypatch,
                                                   combine):
    """With a light volume on a CUDA grid, forward and backward launch the
    kernels, once each, and never reach a plain version; both inputs get a
    gradient."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the CUDA path")
    monkeypatch.setattr(sweep_fwd, "sweep_fwd_reference", refuse)
    monkeypatch.setattr(sweep_bwd, "sweep_bwd_reference", refuse)
    monkeypatch.setattr(sweep_ref_fwd, "sweep_ref_fwd_reference", refuse)
    monkeypatch.setattr(sweep_ref_bwd, "sweep_ref_bwd_reference", refuse)
    if combine == "single":
        grid, cfg, plan, medium = _setup(cuda, EYES[3][0], True)
        mods = (sweep_fwd, sweep_bwd)
    else:
        grid, cfg, plan, medium, _ = _ref_setup(cuda, EYES[3][0], True)
        mods = (sweep_ref_fwd, sweep_ref_bwd)
    lv = _light_volume(grid, cfg, medium, "ones").requires_grad_()
    g = grid.clone().requires_grad_()
    before = [m.launches for m in mods]
    if combine == "single":
        maps = sweep_fwd.sweep_base(g.permute(plan.perm), plan, cfg, medium,
                                    LIGHT, lperm=lv.permute(plan.perm))
    else:
        maps = sweep_ref_fwd.sweep_base_ref(
            g.permute(plan.perm + (3,)), plan, cfg, medium, LIGHT,
            lperm=lv.permute(plan.perm))
    (maps[1].sum() + (maps[2] ** 2).sum()).backward()
    torch.cuda.synchronize()
    assert [m.launches for m in mods] == [b + 1 for b in before]
    for t in (g, lv):
        assert bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["single", "reference"])
def test_gpu_shadowed_render_and_gradient_match_cpu(cuda, combine):
    """render_image with LightConfig(shadow_steps=32) on the card (the
    light sweep, the kernels' light branch, dG and dL) against the same on
    the CPU (the plain versions): image and d/dgrid of sum(rgb^2)."""
    from volumetricrenderer_tpu_torch import cloud_volume, render_image
    if combine == "single":
        grid_c = cloud_volume(32, 7, device="cpu")
        medium, scroll = MediumConfig(combine="single", density=8.0), "none"
    else:
        grid_c = torch.tensor(
            np.random.default_rng(1).uniform(0.1, 1.0, (24, 24, 24, 4)),
            dtype=torch.float32)
        medium, scroll = MediumConfig(combine="reference", density=6.0), \
            "random"
    cam = make_camera(CameraConfig(width=96, height=64))
    cfg = RenderConfig(emission=True, quadrature="sliced")
    imgs, grads = [], []
    for g in (grid_c.to(cuda), grid_c.clone()):
        g.requires_grad_()
        img = render_image(g, cam, cfg, medium, LightConfig(shadow_steps=32),
                           scroll=_scroll(scroll, g.device))
        (img[..., :3] ** 2).sum().backward()
        imgs.append(img.detach().cpu())
        grads.append(g.grad.cpu())
    torch.testing.assert_close(imgs[0], imgs[1], rtol=RTOL, atol=1e-4)
    _assert_grad_close(*grads)


@pytest.mark.gpu
def test_light_launches_validate_inputs(cuda):
    """A light stack of the wrong shape, dtype or device, or one given
    without emission, is refused before any pointer reaches a kernel."""
    grid, cfg, plan, medium = _setup(cuda, EYES[0][0], True)
    (stack, *args), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium)
    stack = stack.contiguous()
    light = torch.ones_like(stack)
    maps = torch.zeros((3,) + plan.base_shape, device=cuda)
    _, _, _, _, inputs = _ref_setup(cuda, EYES[0][0], True)
    slabs = torch.ones_like(inputs[0][:, 0])
    mods = (sweep_fwd, sweep_bwd, sweep_ref_fwd, sweep_ref_bwd)
    before = [m.launches for m in mods]
    for bad, match in ((light[:-1], "light must be"),
                       (light.double(), "float32"),
                       (light.cpu(), "float32 tensor on cuda"),
                       (light.transpose(1, 2), "contiguous")):
        with pytest.raises(ValueError, match=match):
            sweep_fwd.launch_kernel(stack, *args, True, flip, False, bad)
        with pytest.raises(ValueError, match=match):
            sweep_bwd.launch_kernel(stack, *args, *maps, maps[1], maps[2],
                                    True, flip, False, light=bad)
    for bad, match in ((slabs[:, :-1], "light must be"),
                       (slabs.double(), "float32"),
                       (slabs.cpu(), "float32 tensor on cuda")):
        with pytest.raises(ValueError, match=match):
            sweep_ref_fwd.launch_kernel(*inputs, True, bad)
        with pytest.raises(ValueError, match=match):
            sweep_ref_bwd.launch_kernel(*inputs, *maps, maps[1], maps[2],
                                        emission=True, light=bad)
    with pytest.raises(ValueError, match="emission"):
        sweep_fwd.launch_kernel(stack, *args, False, flip, False, light)
    with pytest.raises(ValueError, match="emission"):
        sweep_bwd.launch_kernel(stack, *args, *maps, maps[1], maps[2], False,
                                flip, False, light=light)
    with pytest.raises(ValueError, match="emission"):
        sweep_ref_fwd.launch_kernel(*inputs, False, slabs)
    with pytest.raises(ValueError, match="emission"):
        sweep_ref_bwd.launch_kernel(*inputs, *maps, maps[1], maps[2],
                                    emission=False, light=slabs)
    assert [m.launches for m in mods] == before


# --- the bfloat16 stream mode of the four kernels --------------------------
#
# The kernels' bfloat16 instantiations against the plain versions in the same
# mode (texels and tap weights rounded to bfloat16, everything else float32):
# both read the same bfloat16 stacks and round the weights alike, so the
# float32 tolerances above hold unchanged.

BF16 = torch.bfloat16


def _low(t):
    return None if t is None else t.to(BF16)


@pytest.mark.gpu
def test_device_weight_rounding_matches_torch(cuda):
    """round_weight<__nv_bfloat16> (__float2bfloat16_rn) against
    torch's .to(bfloat16) on seeded weights in [0, 1], exact ties
    included: both round to nearest even, bit for bit."""
    from volumetricrenderer_tpu_torch.kernels.build import bf16_round
    rng = np.random.default_rng(0)
    w = rng.uniform(0.0, 1.0, 8192).astype(np.float32)
    ties = ((w[:2048].view(np.uint32) & np.uint32(0xFFFF0000))
            | np.uint32(0x8000)).view(np.float32)
    x = torch.tensor(np.concatenate([w, 1.0 - w, ties, [0.0, 1.0]]),
                     dtype=torch.float32, device=cuda)
    got = round_weights_on_device(x)
    torch.cuda.synchronize()
    assert int((got != bf16_round(x)).sum()) == 0


def _bf16_case(dev, eye, emission=True, mode="mirror", n_slices=None,
               density=8.0, kind=None):
    """K1 and K2 on bfloat16 stacks (with a light stack when `kind`) and
    their plain versions on the same inputs."""
    grid, cfg, plan, _ = _setup(dev, eye, emission, mode, n_slices)
    medium = MediumConfig(combine="single", density=density)
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        grid.permute(plan.perm), plan, cfg, medium, LIGHT if kind else None)
    stack = _low(stack.contiguous())
    light = None
    if kind:
        lvol = _light_volume(grid, cfg, medium, kind)
        light = _low(sweep_fwd.sweep_light_stack(
            lvol.permute(plan.perm), plan, cfg).contiguous())
    wrap = mode == "wrap"
    before = (sweep_fwd.launches, sweep_bwd.launches)
    maps = sweep_fwd.launch_kernel(stack, *args, emission, flip, wrap, light)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2],
                                  emission, flip, wrap, light=light)
    torch.cuda.synchronize()
    assert (sweep_fwd.launches, sweep_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    kw = dict(emission=emission, flip=flip, address_mode=mode, light=light)
    want_maps = sweep_fwd.sweep_fwd_reference(stack, *args, **kw)
    want = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1],
                                         maps[2], **kw)
    if light is None:
        got, want = (got,), (want,)
    assert all(g.dtype == torch.float32 for g in (*maps, *got))
    return maps, want_maps, got, want


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("emission", [True, False])
@pytest.mark.parametrize("mode", ["mirror", "clamp", "wrap"])
def test_bf16_kernels_match_plain_versions(cuda, eye, axis, sign, emission,
                                           mode):
    _assert_light_case(*_bf16_case(cuda, eye, emission, mode), low=True)


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("mode", ["mirror", "wrap"])
@pytest.mark.parametrize("kind", ["ones", "pushed"])
def test_bf16_light_kernels_match_plain_versions(cuda, eye, axis, sign, mode,
                                                 kind):
    """With rounded weights a fully lit neighbourhood samples just above
    or just below 1: kernel and plain version must decide each such sample
    on the same float, or dL differs by whole shares."""
    _assert_light_case(*_bf16_case(cuda, eye, mode=mode, kind=kind),
                       low=True)


@pytest.mark.gpu
@pytest.mark.parametrize("emission,kind", [(True, None), (False, None),
                                           (True, "ones"), (True, "pushed")])
def test_bf16_kernels_sub_voxel(cuda, emission, kind):
    _assert_light_case(*_bf16_case(cuda, EYES[0][0], emission, n_slices=24,
                                   kind=kind), low=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [None, "ones"])
def test_bf16_backward_kernel_early_stop_gate(cuda, kind):
    """Density 500: the replay reads the very bfloat16 texels and rounds
    the weights as the forward did, so it stops where the forward did."""
    maps, want_maps, got, want = _bf16_case(cuda, EYES[0][0], density=500.0,
                                            kind=kind)
    assert float(maps[1].min()) < 1e-3
    _assert_light_case(maps, want_maps, got, want, tol=5e-4, low=True)


def _bf16_ref_case(dev, eye, emission=True, kind=None, n_slices=None,
                   density=None):
    density = density or (8.0 if kind else 1.0)
    grid, cfg, plan, _, _ = _ref_setup(dev, eye, emission, n_slices=n_slices)
    medium = MediumConfig(combine="reference", density=density)
    scroll = _scroll("random", dev)
    L, *args = sweep_ref_fwd.sweep_ref_inputs(
        grid.permute(plan.perm + (3,)), plan, cfg, medium,
        LIGHT if kind else None, scroll)
    L, light = _low(L), None
    if kind:
        lvol = _light_volume(grid, cfg, medium, kind, scroll)
        light = _low(sweep_ref_fwd.sweep_ref_light_slabs(
            lvol.permute(plan.perm), plan, cfg))
    before = (sweep_ref_fwd.launches, sweep_ref_bwd.launches)
    maps = sweep_ref_fwd.launch_kernel(L, *args, emission, light)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    got = sweep_ref_bwd.launch_kernel(L, *args, *cts, maps[1], maps[2],
                                      emission=emission, light=light)
    torch.cuda.synchronize()
    assert (sweep_ref_fwd.launches, sweep_ref_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want_maps = sweep_ref_fwd.sweep_ref_fwd_reference(
        L, *args, emission=emission, light=light)
    want = sweep_ref_bwd.sweep_ref_bwd_reference(
        L, *args, *cts, maps[1], maps[2], emission=emission, light=light)
    if light is None:
        got, want = (got,), (want,)
    assert all(g.dtype == torch.float32 for g in (*maps, *got))
    return maps, want_maps, got, want


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("emission", [True, False])
def test_bf16_ref_kernels_match_plain_versions(cuda, eye, axis, sign,
                                               emission):
    _assert_light_case(*_bf16_ref_case(cuda, eye, emission), low=True)


@pytest.mark.gpu
@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("kind", ["ones", "pushed"])
def test_bf16_ref_light_kernels_match_plain_versions(cuda, eye, axis, sign,
                                                     kind):
    _assert_light_case(*_bf16_ref_case(cuda, eye, kind=kind), low=True)


@pytest.mark.gpu
def test_bf16_ref_kernels_sub_voxel_and_gate(cuda):
    for emission, kind in ((True, "pushed"), (True, None), (False, None)):
        _assert_light_case(*_bf16_ref_case(cuda, EYES[0][0], emission, kind,
                                           n_slices=24), low=True)
    for kind in (None, "ones"):
        maps, want_maps, got, want = _bf16_ref_case(cuda, EYES[0][0],
                                                    kind=kind, density=500.0)
        assert float(maps[1].min()) < 1e-3
        _assert_light_case(maps, want_maps, got, want, tol=5e-4, low=True)


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["single", "reference"])
@pytest.mark.parametrize("shadows", [False, True],
                         ids=["unshadowed", "shadowed"])
def test_bf16_gpu_render_and_gradient_match_cpu(cuda, combine, shadows):
    """render_image with dtype="bfloat16" on the card (the cast inside the
    node, the kernels' bfloat16 instantiations forward and backward)
    against the same on the CPU (the plain versions): the image, and
    d/dgrid of sum(rgb^2) in float32. Within 3e-2 max / 3e-3 mean of the
    float32 frame."""
    from volumetricrenderer_tpu_torch import cloud_volume, render_image
    if combine == "single":
        grid_c = cloud_volume(32, 7, device="cpu")
        medium, scroll = MediumConfig(combine="single", density=8.0), "none"
    else:
        grid_c = torch.tensor(
            np.random.default_rng(1).uniform(0.1, 1.0, (24, 24, 24, 4)),
            dtype=torch.float32)
        medium, scroll = MediumConfig(combine="reference", density=6.0), \
            "random"
    cam = make_camera(CameraConfig(width=96, height=64))
    cfg = RenderConfig(emission=True, quadrature="sliced", dtype="bfloat16")
    light = LightConfig(shadow_steps=32) if shadows else None
    imgs, grads = [], []
    for g in (grid_c.to(cuda), grid_c.clone()):
        g.requires_grad_()
        img = render_image(g, cam, cfg, medium, light,
                           scroll=_scroll(scroll, g.device))
        (img[..., :3] ** 2).sum().backward()
        assert g.grad.dtype == torch.float32
        imgs.append(img.detach().cpu())
        grads.append(g.grad.cpu())
    torch.testing.assert_close(imgs[0], imgs[1], rtol=RTOL, atol=1e-4)
    _assert_grad_close(*grads)
    f32 = render_image(grid_c.to(cuda), cam, RenderConfig(
        emission=True, quadrature="sliced"), medium, light,
        scroll=_scroll(scroll, cuda)).cpu()
    d = (imgs[0] - f32).abs()
    assert 0.0 < float(d.max()) < 3e-2 and float(d.mean()) < 3e-3


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["single", "reference"])
def test_bf16_cuda_path_never_runs_plain_versions(cuda, monkeypatch,
                                                  combine):
    """In the bfloat16 mode on a CUDA grid, forward and backward launch
    the kernels, once each, and never reach a plain version; a float32 grid
    gets a float32 gradient, a bfloat16 grid a bfloat16 one and the same
    maps."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the CUDA path")
    monkeypatch.setattr(sweep_fwd, "sweep_fwd_reference", refuse)
    monkeypatch.setattr(sweep_bwd, "sweep_bwd_reference", refuse)
    monkeypatch.setattr(sweep_ref_fwd, "sweep_ref_fwd_reference", refuse)
    monkeypatch.setattr(sweep_ref_bwd, "sweep_ref_bwd_reference", refuse)
    if combine == "single":
        grid, cfg, plan, medium = _setup(cuda, EYES[3][0], True)
        mods = (sweep_fwd, sweep_bwd)
    else:
        grid, cfg, plan, medium, _ = _ref_setup(cuda, EYES[3][0], True)
        mods = (sweep_ref_fwd, sweep_ref_bwd)
    cfg = RenderConfig(emission=True, quadrature="sliced", dtype="bfloat16")
    lv = _light_volume(grid, cfg, medium, "pushed")
    out = []
    for dt in (torch.float32, BF16):
        g = grid.to(BF16).to(dt).requires_grad_()
        before = [m.launches for m in mods]
        if combine == "single":
            maps = sweep_fwd.sweep_base(g.permute(plan.perm), plan, cfg,
                                        medium, LIGHT,
                                        lperm=lv.permute(plan.perm))
        else:
            maps = sweep_ref_fwd.sweep_base_ref(
                g.permute(plan.perm + (3,)), plan, cfg, medium, LIGHT,
                lperm=lv.permute(plan.perm))
        (maps[1].sum() + (maps[2] ** 2).sum()).backward()
        torch.cuda.synchronize()
        assert [m.launches for m in mods] == [b + 1 for b in before]
        assert g.grad.dtype == dt and bool(torch.isfinite(g.grad).all())
        assert float(g.grad.abs().max()) > 0
        assert all(m.dtype == torch.float32 for m in maps)
        out.append(maps)
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_launches_validate_inputs(cuda):
    """The stack and the light stack must share one stream type; every
    other input stays float32."""
    grid, cfg, plan, medium = _setup(cuda, EYES[0][0], True)
    (stack, *args), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium)
    stack = stack.contiguous()
    light = torch.ones_like(stack)
    maps = torch.zeros((3,) + plan.base_shape, device=cuda)
    before = (sweep_fwd.launches, sweep_bwd.launches)
    for s, l in ((_low(stack), light), (stack, _low(light))):
        with pytest.raises(ValueError, match="light must be"):
            sweep_fwd.launch_kernel(s, *args, True, flip, False, l)
        with pytest.raises(ValueError, match="light must be"):
            sweep_bwd.launch_kernel(s, *args, *maps, maps[1], maps[2], True,
                                    flip, False, light=l)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sweep_fwd.launch_kernel(stack.half(), *args, True, flip, False)
    with pytest.raises(ValueError, match="seglen"):
        sweep_fwd.launch_kernel(_low(stack), *args[:3], _low(args[3]),
                                args[4], True, flip, False)
    with pytest.raises(ValueError, match="ct_wsum"):
        sweep_bwd.launch_kernel(_low(stack), *args, maps[0], maps[1],
                                _low(maps[2]), maps[1], maps[2], True, flip,
                                False)
    with pytest.raises(ValueError, match="CUDA"):
        round_weights_on_device(torch.ones(4))
    assert (sweep_fwd.launches, sweep_bwd.launches) == before


# --- the tiled schedule of K1 and K2 (csrc/sweep_tile.cuh) ------------------

def _tiled_inputs(dev, eye, emission=True, mode="mirror", n_slices=None,
                  density=8.0, kind=None, low=False, force=None, d=16):
    """The sweep kernels' inputs for one plan: (stack, args, flip, wrap,
    light, cfg, plan, medium); force: the base grid's (Hb, Wb)."""
    from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
    grid = torch.tensor(np.random.default_rng(0).uniform(0.2, 1.0, (d,) * 3),
                        dtype=torch.float32, device=dev)
    cfg = RenderConfig(emission=emission, quadrature="sliced",
                       address_mode=mode)
    plan = plan_sweep(make_camera(CameraConfig(eye=eye, width=96, height=64)),
                      grid.shape, cfg, supersample=cfg.sweep_supersample,
                      n_slices=n_slices, force_base_dims=force, device=dev)
    medium = MediumConfig(combine="single", density=density)
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        grid.permute(plan.perm), plan, cfg, medium, LIGHT if kind else None)
    stack = stack.contiguous()
    light = None
    if kind:
        lvol = _light_volume(grid, cfg, medium, kind)
        light = sweep_fwd.sweep_light_stack(lvol.permute(plan.perm), plan,
                                            cfg).contiguous()
    if low:
        stack = _low(stack)
        light = _low(light) if light is not None else None
    return stack, args, flip, mode == "wrap", light, cfg, plan, medium


def _spans(stack, args, wrap):
    from volumetricrenderer_tpu_torch.kernels import build
    return build.tile_spans(*args[:3], args[4], stack.shape[1],
                            stack.shape[2], wrap)


def _tiled_paths(dev, tol=BWD_TOL, **case):
    """K1 and K2 with the stage the plan sizes, with none (every tile-slice
    through global memory) and with half of it (both paths in one launch):
    K1's maps equal bit for bit across the three and match the plain
    version, K2's gradients match the plain version in each; K1's tally of
    tile-slices agrees with the host mirror (build.tile_slices): none
    through global memory where every window fits, all with no stage.
    Returns the plan's stage in texels."""
    from volumetricrenderer_tpu_torch.kernels import build
    stack, args, flip, wrap, light, cfg, plan, _ = _tiled_inputs(dev, **case)
    em = cfg.emission
    spans = _spans(stack, args, wrap)
    need = build.stage_texels(spans)
    assert need > 1
    kw = dict(emission=em, flip=flip, address_mode=cfg.address_mode,
              light=light)
    want_maps = sweep_fwd.sweep_fwd_reference(stack, *args, **kw)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    first = None
    for stage in (None, 0, need // 2):
        sweep_fwd.tiles.reset()
        sweep_bwd.tiles.reset()
        maps = sweep_fwd.launch_kernel(stack, *args, em, flip, wrap, light,
                                       stage=stage)
        got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2],
                                      em, flip, wrap, light=light,
                                      stage=stage)
        torch.cuda.synchronize()
        done, glob = sweep_fwd.tiles.read()
        cap = build.stage_cap(need if stage is None else stage,
                              build.stage_buffers(False, light is not None))
        active, mirror_glob = build.tile_slices(spans, cap)
        assert 0 < done <= active and glob <= mirror_glob
        if mirror_glob == 0:
            assert glob == 0
        if cap == 0:
            assert glob == done
        if stage == need // 2:
            assert mirror_glob > 0
        if not em:  # no ray ends early: every active tile-slice computed
            assert (done, glob) == (active, mirror_glob)
        if first is None:
            first = maps
            for g, w, n in zip(maps, want_maps, NAMES):
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)
        else:
            assert torch.equal(maps, first)
        want = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1],
                                             maps[2], **kw)
        if light is None:
            got, want = (got,), (want,)
        for g, w in zip(got, want):  # dG (and dL)
            _assert_grad_close(g, w, tol)
    return need


TILED_CASES = {
    "ragged base": dict(eye=EYES[1][0], force=(100, 70)),
    "ragged base, absorption, clamp": dict(eye=EYES[2][0], emission=False,
                                           mode="clamp", force=(70, 100)),
    "sub-voxel stack": dict(eye=EYES[0][0], n_slices=24),
    "absorption": dict(eye=EYES[4][0], emission=False),
    "light, lT exactly 1": dict(eye=EYES[3][0], kind="ones"),
    "light stretched, wrap": dict(eye=EYES[2][0], kind="pushed",
                                  mode="wrap"),
    "bfloat16": dict(eye=EYES[0][0], low=True, mode="clamp"),
    "bfloat16 with light": dict(eye=EYES[4][0], low=True, kind="ones"),
    "texels denser than pixels": dict(eye=EYES[3][0], d=64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TILED_CASES))
def test_tiled_paths_match_plain_versions(cuda, name):
    _tiled_paths(cuda, **TILED_CASES[name])


@pytest.mark.gpu
@pytest.mark.parametrize("low", [False, True])
def test_tiled_window_across_the_wrap_seam(cuda, low):
    """With wrap addressing, windows that cross the seam (unwrapped
    indices below 0 or above n - 1, read modulo n) hold their texels."""
    case = dict(eye=(0.9, 0.8, 1.6), mode="wrap", kind="ones", low=low)
    stack, args, _, wrap, *_ = _tiled_inputs(cuda, **case)
    front, rows, cols = _spans(stack, args, wrap)
    n = stack.shape[1]
    crosses = ((rows[0] < 0) | (rows[1] > n - 1)) & rows[2] & front
    assert bool(crosses.any())
    _tiled_paths(cuda, **case)


@pytest.mark.gpu
def test_tiled_gate_at_density_500(cuda):
    """Tiles whose rays end at different slices: the replay's gate stops
    each pixel where the forward stopped, and the tile's walk ends when no
    pixel is live (fewer tile-slices than its slice range holds)."""
    _tiled_paths(cuda, tol=5e-4, eye=EYES[0][0], density=500.0)
    stack, args, flip, wrap, *_ = _tiled_inputs(cuda, eye=EYES[0][0],
                                                density=500.0)
    from volumetricrenderer_tpu_torch.kernels import build
    sweep_fwd.tiles.reset()
    sweep_fwd.launch_kernel(stack, *args, True, flip, wrap)
    active, _ = build.tile_slices(_spans(stack, args, wrap), 10 ** 6)
    assert sweep_fwd.tiles.read()[0] < active


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["mirror", "wrap"])
def test_tile_tally_matches_host_mirror(cuda, mode):
    """Without an early stop (absorption) every active tile-slice is
    computed: the kernels' tally equals build.tile_slices at each stage."""
    from volumetricrenderer_tpu_torch.kernels import build
    stack, args, flip, wrap, *_ = _tiled_inputs(
        cuda, eye=EYES[3][0], emission=False, mode=mode, force=(96, 130))
    spans = _spans(stack, args, wrap)
    need = build.stage_texels(spans)
    cts = [torch.ones(args[1].numel(), args[2].numel(), device=cuda)] * 3
    for stage in (need, 0, need // 3):
        sweep_fwd.tiles.reset()
        sweep_bwd.tiles.reset()
        maps = sweep_fwd.launch_kernel(stack, *args, False, flip, wrap,
                                       stage=stage)
        sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2], False,
                                flip, wrap, stage=stage)
        want = build.tile_slices(spans, build.stage_cap(
            stage, build.stage_buffers(False, False)))
        assert sweep_fwd.tiles.read() == want
        assert sweep_bwd.tiles.read() == build.tile_slices(
            spans, build.stage_cap(stage, build.stage_buffers(True, False)))


@pytest.mark.gpu
def test_tiled_stage_above_48kb(cuda):
    """A plan whose windows need more than 48 KB of dynamic shared memory
    (128^3 on a 56 x 56 base: 8,832 texels, 70 KB for K1) launches with
    the larger stage, and K2's windows beyond STAGE_BYTES_MAX read through
    global memory."""
    from volumetricrenderer_tpu_torch.kernels import build
    stack, args, flip, wrap, *_ = _tiled_inputs(cuda, eye=EYES[3][0], d=128,
                                                force=(56, 56))
    need = build.stage_texels(_spans(stack, args, wrap))
    assert 4 * 2 * build.stage_cap(need, build.stage_buffers(False, False)) \
        > 48 * 1024
    _tiled_paths(cuda, eye=EYES[3][0], d=128, force=(56, 56))


# --- the tiled schedule of K4 and K5 (csrc/sweep_ref_tile.cuh) -------------

def _ref_tiled_inputs(dev, eye, emission=True, seed=5, n_slices=None,
                      force=None, density=1.0, kind=None, low=False,
                      scales=None, d=16):
    """The 4-channel kernels' inputs for one plan and a seeded (4, 3)
    scroll: (L, args, light, cfg, plan); force: the base grid's (Hb, Wb);
    scales: the channels' coordinate scales."""
    from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
    grid = torch.tensor(
        np.random.default_rng(0).uniform(0.1, 1.0, (d, d, d, 4)),
        dtype=torch.float32, device=dev)
    cfg = RenderConfig(emission=emission, quadrature="sliced")
    plan = plan_sweep(make_camera(CameraConfig(eye=eye, width=96, height=64)),
                      grid.shape, cfg, supersample=cfg.sweep_supersample,
                      n_slices=n_slices, force_base_dims=force, device=dev)
    medium = MediumConfig(density=density, **(
        {"channel_coord_scale": scales} if scales else {}))
    scroll = torch.tensor(np.random.default_rng(seed).uniform(-1.5, 1.5,
                                                              (4, 3)),
                          dtype=torch.float32, device=dev)
    L, *args = sweep_ref_fwd.sweep_ref_inputs(
        grid.permute(plan.perm + (3,)), plan, cfg, medium,
        LIGHT if kind else None, scroll)
    L, light = L.contiguous(), None
    if kind:
        lvol = _light_volume(grid, cfg, medium, kind, scroll)
        light = sweep_ref_fwd.sweep_ref_light_slabs(lvol.permute(plan.perm),
                                                    plan, cfg).contiguous()
    if low:
        L, light = _low(L), _low(light)
    return L, args, light, cfg, plan


def _ref_spans(L, args, light):
    from volumetricrenderer_tpu_torch.kernels import build
    A, B = L.shape[2], L.shape[3]
    spans = build.ref_tile_spans(*args[:3], args[4], A, B)
    lspans = (build.tile_spans(*args[:3], args[4], A, B, False)
              if light is not None else None)
    return spans, lspans


def _ref_tiled_paths(dev, tol=BWD_TOL, **case):
    """K4 and K5 with the stage the plan sizes (build.ref_stage_for), with
    none (every tile-slice through global memory) and with half the largest
    window (both paths in one launch): K4's maps equal bit for bit across
    the three and match the plain version, K5's gradients match the plain
    version in each; the kernels' tallies agree with the host mirror
    (build.ref_tile_slices). Returns (largest window, stage bound)."""
    from volumetricrenderer_tpu_torch.kernels import build
    L, args, light, cfg, plan = _ref_tiled_inputs(dev, **case)
    em, lit = cfg.emission, light is not None
    spans, lspans = _ref_spans(L, args, light)
    need = build.ref_stage_texels(spans, lspans)
    bound = build.ref_stage_for(*args[:3], args[4], L.shape[2], L.shape[3],
                                light=lit)
    assert 1 < need <= bound
    want_maps = sweep_ref_fwd.sweep_ref_fwd_reference(L, *args, emission=em,
                                                      light=light)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    first = None
    for stage in (None, 0, need // 2):
        sweep_ref_fwd.tiles.reset()
        sweep_ref_bwd.tiles.reset()
        maps = sweep_ref_fwd.launch_kernel(L, *args, em, light, stage=stage)
        got = sweep_ref_bwd.launch_kernel(L, *args, *cts, maps[1], maps[2],
                                          emission=em, light=light,
                                          stage=stage)
        torch.cuda.synchronize()
        done, glob = sweep_ref_fwd.tiles.read()
        size = bound if stage is None else stage
        active, mirror_glob = build.ref_tile_slices(
            spans, build.ref_stage_cap(size, False, lit), lspans)
        _, mirror_bglob = build.ref_tile_slices(
            spans, build.ref_stage_cap(size, True, lit), lspans)
        assert 0 < done <= active and glob <= mirror_glob
        if mirror_glob == 0:
            assert glob == 0
        if stage == 0:
            assert glob == done
        if stage == need // 2:
            assert mirror_glob > 0
        if not em:  # no ray ends early: every active tile-slice computed
            assert (done, glob) == (active, mirror_glob)
            assert sweep_ref_bwd.tiles.read() == (active, mirror_bglob)
        if first is None:
            first = maps
            for g, w, n in zip(maps, want_maps, NAMES):
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)
        else:
            assert torch.equal(maps, first)
        want = sweep_ref_bwd.sweep_ref_bwd_reference(
            L, *args, *cts, maps[1], maps[2], emission=em, light=light)
        if light is None:
            got, want = (got,), (want,)
        for g, w in zip(got, want):  # dL (and the light slabs' dL)
            _assert_grad_close(g, w, tol)
    return need, bound


REF_TILED_CASES = {
    "seeded scroll": dict(eye=EYES[0][0]),
    "ragged base": dict(eye=EYES[1][0], force=(100, 70)),
    "ragged base, absorption": dict(eye=EYES[2][0], emission=False,
                                    force=(70, 100)),
    "sub-voxel stack": dict(eye=EYES[0][0], n_slices=24),
    "absorption": dict(eye=EYES[4][0], emission=False, seed=6),
    "scale above 1": dict(eye=EYES[3][0], force=(20, 20),
                          scales=(2.5, 0.8, 3.1, 0.7)),
    "scale above 1, absorption": dict(eye=EYES[1][0], emission=False,
                                      force=(20, 20),
                                      scales=(2.5, 0.8, 3.1, 0.7)),
    "negative scale": dict(eye=EYES[2][0], scales=(1.0, -0.8, 0.75, 0.7)),
    "light, lT exactly 1": dict(eye=EYES[3][0], kind="ones", density=8.0),
    "light stretched": dict(eye=EYES[2][0], kind="pushed", density=8.0),
    "bfloat16": dict(eye=EYES[0][0], low=True),
    "bfloat16, absorption": dict(eye=EYES[1][0], low=True, emission=False),
    "bfloat16 with light": dict(eye=EYES[4][0], low=True, kind="ones",
                                density=8.0),
    "texels denser than pixels": dict(eye=EYES[3][0], d=64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(REF_TILED_CASES))
def test_ref_tiled_paths_match_plain_versions(cuda, name):
    _ref_tiled_paths(cuda, **REF_TILED_CASES[name])


@pytest.mark.gpu
@pytest.mark.parametrize("low", [False, True])
def test_ref_windows_across_the_mirror_fold(cuda, low):
    """Seeded scrolls put channel windows across a mirror fold (unmirrored
    slots below 0 or above n - 1, two slots on one texel): reads and the
    flush's adds land on the folded texels."""
    case = dict(eye=EYES[3][0], seed=7, low=low)
    L, args, light, *_ = _ref_tiled_inputs(cuda, **case)
    (front, rows, cols), _ = _ref_spans(L, args, light)
    n = L.shape[2]
    on = front[None, None, :] & rows[2][None]
    crosses = ((rows[0] < 0) | (rows[1] > n - 1)) & on
    assert bool(crosses.any())
    _ref_tiled_paths(cuda, **case)


@pytest.mark.gpu
def test_ref_tiled_gate_at_density_500(cuda):
    """Tiles whose rays end at different slices: K5's replay stops each
    pixel where K4 stopped, and the walk ends when no pixel is live."""
    from volumetricrenderer_tpu_torch.kernels import build
    _ref_tiled_paths(cuda, tol=5e-4, eye=EYES[0][0], density=500.0)
    L, args, light, *_ = _ref_tiled_inputs(cuda, eye=EYES[0][0],
                                           density=500.0)
    sweep_ref_fwd.tiles.reset()
    maps = sweep_ref_fwd.launch_kernel(L, *args, True)
    assert float(maps[1].min()) < 1e-3
    active, _ = build.ref_tile_slices(_ref_spans(L, args, light)[0], 10 ** 6)
    assert sweep_ref_fwd.tiles.read()[0] < active


@pytest.mark.gpu
def test_ref_windows_beyond_the_stage(cuda):
    """A plan whose windows exceed what a stage may hold (128^3 x 4 on a
    56 x 56 base): K4 launches with more than 48 KB of shared memory and
    reads the larger windows through global memory, K5 (whose stage also
    holds the eight warps' accumulation windows) reads and scatters them
    there; both tallies show it, and both match the plain versions."""
    from volumetricrenderer_tpu_torch.kernels import build
    case = dict(eye=EYES[3][0], d=128, force=(56, 56), emission=False)
    L, args, light, *_ = _ref_tiled_inputs(cuda, **case)
    spans, _ = _ref_spans(L, args, light)
    bound = build.ref_stage_for(*args[:3], args[4], 128, 128)
    cap_f = build.ref_stage_cap(bound, False, False)
    assert 4 * 2 * 4 * cap_f > 48 * 1024
    assert build.ref_tile_slices(spans, cap_f)[1] > 0
    assert build.ref_tile_slices(
        spans, build.ref_stage_cap(bound, True, False))[1] > 0
    _ref_tiled_paths(cuda, **case)


@pytest.mark.gpu
def test_ref_frames_with_new_scrolls_keep_the_stage(cuda, monkeypatch):
    """render_image with a new scroll in every frame sizes the stage once
    for the plan and medium (no read to the host per frame), and every
    tile-slice of those frames is staged."""
    from volumetricrenderer_tpu_torch import render_image
    from volumetricrenderer_tpu_torch.kernels import build
    grid = torch.tensor(
        np.random.default_rng(0).uniform(0.1, 1.0, (16, 16, 16, 4)),
        dtype=torch.float32, device=cuda)
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = make_camera(CameraConfig(eye=EYES[3][0], width=96, height=64))
    plan = plan_for(cam, grid.shape, cfg, device=cuda)
    calls = []
    real = build.ref_stage_bound

    def counted(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(build, "ref_stage_bound", counted)
    sweep_ref_fwd.tiles.reset()
    for seed in (5, 6, 7, 8):
        scroll = torch.tensor(np.random.default_rng(seed).uniform(
            -1.5, 1.5, (4, 3)), dtype=torch.float32, device=cuda)
        img = render_image(grid, cam, cfg, MediumConfig(), scroll=scroll,
                           plan=plan)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())
    assert len(calls) == 1
    done, glob = sweep_ref_fwd.tiles.read()
    assert done > 0 and glob == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cloud_volume", "build_volume",
                                  "smoke_volume", "translate_w2l",
                                  "config3_scene"])
def test_scene_constructors_default_to_the_gpu(cuda, name):
    """Without device=, the volume and scene constructors build on the
    card."""
    from volumetricrenderer_tpu_torch import VolumeConfig
    from volumetricrenderer_tpu_torch.models import scene
    args = {"cloud_volume": (12, 7), "build_volume": (VolumeConfig(size=8),),
            "smoke_volume": (12, 23), "translate_w2l": (0.25, -0.5, 0.125),
            "config3_scene": (8,)}[name]
    got = getattr(scene, name)(*args)
    tensors = ([t for v in got for t in (v.grid, v.world_to_local)]
               if isinstance(got, list) else [got])
    assert all(t.device.type == "cuda" for t in tensors)


@pytest.mark.gpu
def test_fit_grid_numpy_target_runs_on_the_gpu(cuda):
    """fit_grid with a numpy target and no init_grid fits on the card by
    default, through both kernels once per step."""
    from volumetricrenderer_tpu_torch.fit import fit_grid
    target = np.random.default_rng(4).uniform(0.0, 0.5, (24, 32, 3)).astype(
        np.float32)
    cam = make_camera(CameraConfig(width=32, height=24))
    cfg = RenderConfig(emission=True, quadrature="sliced")
    before = (sweep_fwd.launches, sweep_bwd.launches)
    res = fit_grid(target, cam, cfg, MediumConfig(combine="single",
                                                  density=8.0),
                   grid_size=12, steps=3)
    torch.cuda.synchronize()
    assert res.grid.device.type == "cuda"
    assert (sweep_fwd.launches, sweep_bwd.launches) == (before[0] + 3,
                                                        before[1] + 3)
    assert all(np.isfinite(res.losses)) and res.skipped_steps == 0


# --- K1's and K2's static shared memory in the 48 KB opt-in check --------

# A block may use 48 KB of shared memory, static and dynamic together,
# without opting in. K1 and K2 hold 32 + 32 Line records of 16 bytes
# statically (csrc/sweep_tile.cuh kStaticSmem); a stage whose dynamic bytes
# land in (48 KB - 1 KB, 48 KB] is refused at launch unless the launcher
# counts them.
SMEM_DEFAULT = 48 * 1024
LINE_SMEM = (32 + 32) * 16


def _stage_in_band(S, backward, light):
    """The stage (texel slots a window buffer) whose launch takes the most
    dynamic shared memory that is still at most 48 KB."""
    from volumetricrenderer_tpu_torch.kernels import build
    buffers = build.stage_buffers(backward, light)
    cap = (SMEM_DEFAULT - 16 * S) // (4 * buffers)
    assert build.stage_cap(cap, buffers) == cap
    assert SMEM_DEFAULT - LINE_SMEM < 16 * S + 4 * buffers * cap \
        <= SMEM_DEFAULT
    return cap


@pytest.mark.gpu
@pytest.mark.parametrize("light", [False, True])
def test_stage_in_the_static_shared_memory_band(cuda, light):
    """K1 and K2, float32, with a stage in the band that the launchers
    refused before they counted their static shared memory: they launch
    and match their plain versions."""
    grid, cfg, plan, medium = _setup(cuda, EYES[0][0], True)
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        grid.permute(plan.perm), plan, cfg, medium, LIGHT)
    stack = stack.contiguous()
    lstack = None
    if light:
        lstack = sweep_fwd.sweep_light_stack(
            _light_volume(grid, cfg, medium, "pushed").permute(plan.perm),
            plan, cfg).contiguous()
    S = stack.shape[0]
    maps = sweep_fwd.launch_kernel(stack, *args, True, flip, False, lstack,
                                   stage=_stage_in_band(S, False, light))
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=cuda) for _ in range(3)]
    got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2], True,
                                  flip, False, light=lstack,
                                  stage=_stage_in_band(S, True, light))
    torch.cuda.synchronize()
    kw = dict(emission=True, flip=flip, address_mode="mirror", light=lstack)
    want_maps = sweep_fwd.sweep_fwd_reference(stack, *args, **kw)
    want = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1],
                                         maps[2], **kw)
    for g, w, n in zip(maps, want_maps, NAMES):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)
    for g, w in zip(got if light else (got,), want if light else (want,)):
        _assert_grad_close(g, w)


# --- the viewer front end on the card: serve and animate ------------------


def _front_preset(name, size=32, width=96, height=64):
    import dataclasses

    from volumetricrenderer_tpu_torch import get_preset
    p = get_preset(name)
    return dataclasses.replace(
        p, volume=dataclasses.replace(p.volume, size=size),
        camera=dataclasses.replace(p.camera, width=width, height=height))


def _served_uint8(img):
    """serve.py's conversion: RGB over the page background, to uint8."""
    from volumetricrenderer_tpu_torch.serve import _PAGE_BG
    a = img[..., 3:4]
    rgb = img[..., :3] * a + _PAGE_BG * (1.0 - a)
    return torch.clamp(rgb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8) \
        .cpu().numpy()


def _frame_of_state(r):
    """render_image at the renderer's current state and cached plan."""
    from volumetricrenderer_tpu_torch import render_image
    plan = r._plan_cached(r.azim, r.elev, r.dist)
    with torch.no_grad():
        return render_image(r.grid, None, r.cfg, r.medium, r.light,
                            plan=plan, backend="sweep")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["config2", "config4"])
def test_render_frame_is_render_image_in_uint8(cuda, name):
    from volumetricrenderer_tpu_torch.serve import InteractiveRenderer
    r = InteractiveRenderer(_front_preset(name), probe=4, device=cuda)
    r.key(" ")  # pause the media clock
    for keys in ("", "dq", "ww"):
        for k in keys:
            r.key(k)
        before = sweep_fwd.launches
        got = r.render_frame()
        assert sweep_fwd.launches == before + 1
        assert got.shape == (64, 96, 3) and got.dtype == np.uint8
        assert np.array_equal(got, _served_uint8(_frame_of_state(r)))


@pytest.mark.gpu
def test_cached_frame_dispatch_does_not_synchronize(cuda):
    """A frame at a state whose plan is cached enqueues its work and its
    copy to the host without waiting for the device."""
    from volumetricrenderer_tpu_torch.serve import InteractiveRenderer
    r = InteractiveRenderer(_front_preset("config4"), probe=4, device=cuda)
    want = r.render_frame()  # builds the plan and the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = r.dispatch_frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.array_equal(pending.fetch(), want)


class _Cycling:
    """Dispatches the k-th frame at azimuth lattice step k % n."""

    def __init__(self, renderer, n):
        self.r, self.n, self.frames_rendered = renderer, n, 0

    def dispatch_frame(self):
        self.r._az_idx = self.frames_rendered % self.n
        self.frames_rendered += 1
        return self.r.dispatch_frame()


@pytest.mark.gpu
def test_frameloop_frames_arrive_in_order_and_unaltered(cuda):
    """Four states dispatched back to back through the FrameLoop, two
    frames in flight: every served frame is its own state's frame, in
    dispatch order, and stays so while later frames are copied."""
    from volumetricrenderer_tpu_torch.serve import FrameLoop, \
        InteractiveRenderer
    r = InteractiveRenderer(_front_preset("config2"), probe=4, device=cuda)
    r.key(" ")
    want = []
    for k in range(4):
        r._az_idx = k
        want.append(r.render_frame().copy())
    assert all(np.abs(want[k].astype(int) - want[0].astype(int)).max() > 0
               for k in (1, 2, 3))
    loop = FrameLoop(_Cycling(r, 4))
    served = []
    try:
        seq = 0
        for _ in range(12):
            seq, img = loop.next_frame(seq, timeout=60)
            served.append((seq, img, img.copy()))
    finally:
        loop.stop()
    assert not loop.thread.is_alive()
    seqs = [s for s, _, _ in served]
    assert seqs == sorted(set(seqs))
    for s, img, copy in served:
        assert np.array_equal(img, copy)  # not overwritten since
        assert np.array_equal(img, want[(s - 1) % 4]), s


def _read_png(path):
    """Decode an 8-bit PNG of utils/image.write_png (one IDAT, filter 0)."""
    import struct
    import zlib
    data = open(path, "rb").read()
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks.setdefault(tag, data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8) \
        .reshape(h, 1 + w * c)
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.gpu
def test_cli_animate_on_the_card_writes_render_image_frames(cuda, tmp_path):
    """`cli animate --device cuda` (config 4, shadows, orbit) launches K1
    once a frame and writes render_image's frames at the path's forced
    base dims."""
    import math

    from volumetricrenderer_tpu_torch import build_volume, cli, \
        orbit_camera, render_image
    from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
    out = tmp_path / "anim"
    before = sweep_fwd.launches
    assert cli.main(["animate", "--preset", "config4", "--volume-size",
                     "32", "--width", "96", "--height", "64", "--frames",
                     "3", "--orbit", "--out-dir", str(out), "--device",
                     "cuda"]) == 0
    assert sweep_fwd.launches == before + 3
    p = _front_preset("config4")
    grid = build_volume(p.volume, device=cuda)
    cams = [orbit_camera(2 * math.pi * i / 3, width=96, height=64)
            for i in range(3)]
    dims = cli.animation_base_dims(cams, grid.shape[:3], p.render)
    for i, cam in enumerate(cams):
        plan = plan_sweep(cam, grid.shape[:3], p.render,
                          supersample=p.render.sweep_supersample,
                          force_base_dims=dims, device=cuda)
        with torch.no_grad():
            img = render_image(grid, None, p.render, p.medium, p.light,
                               plan=plan, backend="sweep")
        want = torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        assert np.array_equal(_read_png(out / f"frame_{i:05d}.png"),
                              want.cpu().numpy()), i


@pytest.mark.gpu
@pytest.mark.parametrize("eye", [EYES[0][0], EYES[4][0]])
@pytest.mark.parametrize("n_slab,n_data", [(2, 1), (4, 2), (2, 2)])
@pytest.mark.parametrize("combine", ["single", "reference", "shadowed"])
def test_slab_split_matches_the_unsharded_kernels(cuda, eye, n_slab, n_data,
                                                  combine):
    """The sharded sweep's per-rank body on every block (split_sweep: K1/K2
    or K4/K5 on local blocks, n_slab * n_data launches of each, no general
    sweep), against the unsharded kernels: maps at 2e-4 (gate off), the
    gradients of the grid (and of the light volume, shadowed) on seeded
    cotangents at rtol 1e-3, atol 1e-3 * max (the JAX sharded tests'
    tolerances); with the early stop on, the frame within 20 eps."""
    from volumetricrenderer_tpu_torch.ops import sweep as ops_sweep
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import \
        split_sweep
    cfg = RenderConfig(emission=True, quadrature="sliced",
                       early_stop_transmittance=-1.0)
    rng = np.random.default_rng(1)
    scroll = lvol = None
    if combine != "reference":
        grid = torch.tensor(rng.uniform(0.2, 1.0, (16, 16, 16)),
                            dtype=torch.float32, device=cuda)
        medium, mods = MediumConfig(combine="single", density=8.0), \
            (sweep_fwd, sweep_bwd)
        if combine == "shadowed":
            lvol = light_transmittance_volume(
                grid, LightConfig(shadow_steps=16), cfg, medium)
    else:
        grid = torch.tensor(rng.uniform(0.1, 1.0, (16, 16, 16, 4)),
                            dtype=torch.float32, device=cuda)
        scroll = torch.tensor(rng.uniform(-1.5, 1.5, (4, 3)),
                              dtype=torch.float32, device=cuda)
        medium, mods = MediumConfig(density=4.0), (sweep_ref_fwd,
                                                   sweep_ref_bwd)
    plan = plan_for(make_camera(CameraConfig(eye=eye, width=96, height=64)),
                    grid.shape[:3], cfg, device=cuda)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=cuda) for _ in range(3)]

    def run(split):
        g = grid.clone().requires_grad_()
        lv = None if lvol is None else lvol.clone().requires_grad_()
        lperm = None if lv is None else lv.permute(plan.perm)
        perm = plan.perm + ((3,) if g.dim() == 4 else ())
        before = [m.launches for m in mods] + [ops_sweep.general_calls]
        if split:
            maps = split_sweep(g, plan, cfg, medium, n_slab, n_data, scroll,
                               lv)
        elif g.dim() == 3:
            maps = sweep_fwd.sweep_base(g.permute(perm), plan, cfg, medium,
                                        lperm=lperm)
        else:
            maps = sweep_ref_fwd.sweep_base_ref(g.permute(perm), plan, cfg,
                                                medium, scroll=scroll)
        sum((m * c).sum() for m, c in zip(maps[:3], cts)).backward()
        torch.cuda.synchronize()
        after = [m.launches for m in mods] + [ops_sweep.general_calls]
        return maps, (g.grad, None if lv is None else lv.grad), \
            [a - b for a, b in zip(after, before)]

    got, grads, launches = run(True)
    want, grads_want, _ = run(False)
    assert launches == [n_slab * n_data] * 2 + [0]
    for g, w, n in zip(got, want, NAMES):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4, msg=n)
    for dg, dg_want in zip(grads, grads_want):
        if dg_want is not None:
            scale = float(dg_want.abs().max())
            torch.testing.assert_close(dg, dg_want, rtol=1e-3,
                                       atol=1e-3 * scale)
    if combine == "single":  # the preset's gate
        from volumetricrenderer_tpu_torch.ops.sweep import finish_image
        gate = RenderConfig(emission=True, quadrature="sliced")
        with torch.no_grad():
            gated = finish_image(split_sweep(grid, plan, gate, medium, n_slab,
                                             n_data), plan, gate, medium)
            whole = render_image(grid, None, gate, medium, plan=plan)
        assert float((gated - whole).abs().max()) < 20 * 1e-3


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.mark.gpu
def test_one_rank_nccl_mesh_equals_render_image(cuda):
    """initialize_distributed starts a one-process NCCL group (tcp on
    localhost); sweep_render_sharded on its 1x1 mesh equals
    render_image on the same plan bit for bit, with one K1 launch, at
    voxel-plane and sub-voxel slices; its train step launches K1 and K2
    once a step and runs no index_put_ backward."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from volumetricrenderer_tpu_torch import cloud_volume
    from volumetricrenderer_tpu_torch.parallel.bootstrap import \
        initialize_distributed
    from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import (
        make_sweep_train_step, sweep_render_sharded)
    from volumetricrenderer_tpu_torch.parallel import bootstrap
    assert initialize_distributed(coordinator_address=f"localhost:"
                                  f"{_free_port()}",
                                  num_processes=1, process_id=0, retries=1)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(device="cuda")
        grid = cloud_volume(32, 7, device=cuda)
        cam = make_camera(CameraConfig(width=96, height=64))
        cfg = RenderConfig(emission=True, quadrature="sliced")
        medium = MediumConfig(combine="single", density=8.0)
        plan = plan_for(cam, grid.shape, cfg, device=cuda)
        for p in (plan_for(cam, grid.shape, cfg, n_slices=16, device=cuda),
                  plan):  # sub-voxel slices, then the voxel planes
            before = sweep_fwd.launches
            img = sweep_render_sharded(grid, p, mesh, cfg, medium)
            assert sweep_fwd.launches == before + 1
            assert torch.equal(img, render_image(grid, cam, cfg, medium,
                                                 plan=p))
        g = torch.full_like(grid, 0.1)
        step, _ = make_sweep_train_step(mesh, plan, cfg, medium, g,
                                        learning_rate=5e-2)
        before = (sweep_fwd.launches, sweep_bwd.launches)
        losses = [step(img[..., :3]) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            losses.append(step(img[..., :3]))
            torch.cuda.synchronize()
        assert (sweep_fwd.launches, sweep_bwd.launches) == \
            (before[0] + 3, before[1] + 3)
        assert losses[-1] < losses[0]
        assert not [e.name for e in prof.events()  # the warp's own splat
                    if "indexing_backward_kernel" in e.name
                    or "IndexBackward" in e.name
                    or "IndexPutBackward" in e.name]
    finally:
        dist.destroy_process_group()
        bootstrap._initialized = False


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["reference clamp", "reference wrap",
                                  "light of another shape",
                                  "absorption with light"])
def test_repaired_configurations_on_the_card(cuda, case):
    """The configurations no kernel covers take the general sweep on the
    card too (no kernel launch) and equal the same call on the CPU; a
    light volume with absorption is dropped and K1 sweeps."""
    from volumetricrenderer_tpu_torch.ops.sweep import sweep_render
    rng = np.random.default_rng(2)
    cfg = RenderConfig(emission=True, quadrature="sliced")
    grid = rng.uniform(0.1, 1.0, (16, 16, 16, 4)).astype(np.float32)
    medium, scroll, lvol = MediumConfig(density=4.0), \
        rng.uniform(-1.5, 1.5, (4, 3)).astype(np.float32), None
    if case.startswith("reference"):
        cfg = RenderConfig(emission=True, quadrature="sliced",
                           address_mode=case.split()[1])
    else:
        medium, scroll, grid = MediumConfig(combine="single", density=8.0), \
            None, grid[..., 0].copy()
        lvol = rng.uniform(0.0, 1.0, (12, 20, 10) if "shape" in case
                           else (16, 16, 16)).astype(np.float32)
        if "absorption" in case:
            cfg = RenderConfig(emission=False, quadrature="sliced")
    plan = plan_for(make_camera(CameraConfig(eye=EYES[0][0], width=96,
                                             height=64)),
                    grid.shape[:3], cfg, device="cpu")
    plan_gpu = plan_for(make_camera(CameraConfig(eye=EYES[0][0], width=96,
                                                 height=64)),
                        grid.shape[:3], cfg, device=cuda)

    def call(dev, p):
        def t(x):
            return None if x is None else torch.from_numpy(x).to(dev)
        return sweep_render(t(grid), p, cfg, medium, scroll=t(scroll),
                            light_volume=t(lvol))
    before = sweep_fwd.launches + sweep_ref_fwd.launches
    got = call(cuda, plan_gpu).cpu()
    launched = sweep_fwd.launches + sweep_ref_fwd.launches - before
    assert launched == (1 if "absorption" in case else 0)
    torch.testing.assert_close(got, call("cpu", plan), rtol=RTOL, atol=1e-4)


# --- the screen warp's written-out adjoint (ops/sweep.py _WarpBilinear) ----

def _four_gathers(base, rows01, cols01):
    """The warp as autograd sees a plain gather: clip-then-tent taps and
    four advanced-indexing gathers (the expression the op's forward
    computes), whose backward is index_put_ with accumulate."""
    def taps(q01, n):
        p = torch.clamp(q01 * n - 0.5, 0.0, float(n - 1))
        i0f = torch.floor(p)
        i0 = i0f.to(torch.int64)
        return i0, torch.clamp(i0 + 1, max=n - 1), (p - i0f)[..., None]
    r0, r1, fr = taps(rows01, base.shape[0])
    c0, c1, fc = taps(cols01, base.shape[1])
    return ((1.0 - fc) * ((1.0 - fr) * base[r0, c0] + fr * base[r1, c0])
            + fc * ((1.0 - fr) * base[r0, c1] + fr * base[r1, c1]))


def _flagship_plan(dev):
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = make_camera(CameraConfig(width=1920, height=1080))
    return cam, cfg, plan_for(cam, (256, 256, 256), cfg, device=dev)


# The warp's plans (camera, grid, rows of the band or None) and the pixels
# in their base footprint, counted from the same plans on the CPU: the
# flagship (256^3 at 1920x1080), config 3's (256^3 at 1024^2 from (3, 3,
# 3)), config 5's (512^3 at 1920x1080), and one row band of the flagship's.
WARP_PLANS = {
    "flagship": ((1920, 1080), 256, None, 567100),
    "config3": ((1024, 1024), 256, None, 487482),
    "config5": ((1920, 1080), 512, None, 568190),
    "flagship band": ((1920, 1080), 256, (270, 540), None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("miss", [(0.0, 1.0), None])
@pytest.mark.parametrize("name", list(WARP_PLANS))
def test_warp_adjoint_at_flagship_width(cuda, name, miss):
    """At the flagship's, config 3's and config 5's plans and a row band of
    the flagship's (the two channels the warp carries), with the miss
    select and without: the kernel forward (one launch) equals the four
    gathers, and the where, bit for bit; the kernel backward (one launch)
    gives the base gradient of autograd of the same expression within
    1e-6 of its largest (the two sum a texel's taps in another order), and
    splat_pixels() counts the footprint's pixels with the miss, every pixel
    without. The cotangent is seeded normal in the footprint; outside it,
    seeded normal too with the miss (whose select zeroes it, so the kernel
    must add none of it) and zero without: there every pixel takes an edge
    texel, whose sum of tens of thousands of taps would differ by its order
    alone (test_warp_splats_every_pixel_without_a_miss holds those adds)."""
    from volumetricrenderer_tpu_torch.kernels import warp_bilinear
    from volumetricrenderer_tpu_torch.ops.sweep import _in01, \
        warp_base_to_pixels
    (width, height), size, band, footprint = WARP_PLANS[name]
    cfg = RenderConfig(emission=True, quadrature="sliced")
    plan = plan_for(make_camera(CameraConfig(width=width, height=height)),
                    (size,) * 3, cfg, device=cuda)
    if band is not None:
        plan = dataclasses.replace(
            plan, warp_rows01=plan.warp_rows01[band[0]:band[1]],
            warp_cols01=plan.warp_cols01[band[0]:band[1]])
    rows, cols = plan.warp_rows01, plan.warp_cols01
    inr = (_in01(rows) & _in01(cols))[..., None]
    if footprint is not None:
        assert int(inr.sum()) == footprint
    gen = torch.Generator(device=cuda).manual_seed(4)
    base = torch.rand(plan.base_shape + (2,), generator=gen, device=cuda)
    ct = torch.randn(tuple(rows.shape) + (2,), generator=gen, device=cuda)
    if miss is None:
        ct = torch.where(inr, ct, 0.0)
    b1 = base.clone().requires_grad_()
    b2 = base.clone().requires_grad_()
    before = dict(warp_bilinear.launches)
    got = warp_base_to_pixels(b1, plan, miss=miss)
    want = _four_gathers(b2, rows, cols)
    if miss is not None:
        want = torch.where(inr, want, torch.tensor(miss, device=cuda))
    assert torch.equal(got, want)
    got.backward(ct)
    want.backward(ct)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == {"forward": before["forward"] + 1,
                                      "backward": before["backward"] + 1}
    assert warp_bilinear.splat_pixels() == (
        int(inr.sum()) if miss is not None else rows.numel(), rows.numel())
    scale = float(b2.grad.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(b1.grad, b2.grad, rtol=0.0,
                               atol=1e-6 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_warp_splats_every_pixel_without_a_miss(cuda, channels):
    """Without a miss the kernel pair takes every pixel, the out-of-
    footprint ones at their clamped edge texels: at a small plan (the
    sweep tests' first eye at 96x64, 1,428 of its 6,144 pixels outside) with
    1 to 4 channels and a cotangent seeded normal everywhere, the forward
    equals the plain version bit for bit and the gradient equals it to the
    suite's tolerance for atomic sums (BWD_TOL); with a scalar miss the
    same holds and the outside pixels take it."""
    from volumetricrenderer_tpu_torch.kernels import warp_bilinear
    from volumetricrenderer_tpu_torch.ops.sweep import _in01, \
        warp_base_to_pixels
    _, cfg, plan, _ = _setup(cuda, EYES[0][0], True)
    rows, cols = plan.warp_rows01, plan.warp_cols01
    inr = (_in01(rows) & _in01(cols))[..., None]
    assert 0 < int(inr.sum()) < rows.numel()
    gen = torch.Generator(device=cuda).manual_seed(channels)
    base = torch.rand(plan.base_shape + (channels,), generator=gen,
                      device=cuda)
    ct = torch.randn(tuple(rows.shape) + (channels,), generator=gen,
                     device=cuda)
    for miss in (None, 0.25):
        b = base.clone().requires_grad_()
        got = warp_base_to_pixels(b, plan, miss=miss)
        grad, = torch.autograd.grad(got, b, ct)
        want = warp_bilinear.warp_reference(
            base, rows, cols,
            None if miss is None else torch.tensor(miss, device=cuda))
        assert torch.equal(got, want)
        assert warp_bilinear.splat_pixels() == (
            rows.numel() if miss is None else int(inr.sum()), rows.numel())
        want_grad = warp_bilinear.splat_reference(
            ct, rows, cols, tuple(base.shape), miss is not None)
        torch.testing.assert_close(
            grad, want_grad, rtol=BWD_TOL,
            atol=BWD_TOL * float(want_grad.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case,match", [
    ("float64 base", "base must be float32"),
    ("bfloat16 base", "base must be float32"),
    ("float64 maps", "rows01 must be float32"),
    ("five channels", "1 <= C <= 4")])
def test_warp_on_the_card_refuses_what_the_kernel_cannot_take(cuda, case,
                                                              match):
    """On a CUDA base the warp is the kernel or a ValueError, never the
    plain version's torch ops: a base or maps not float32, or more than 4
    channels, are refused before anything is launched or counted."""
    from volumetricrenderer_tpu_torch.kernels import warp_bilinear
    from volumetricrenderer_tpu_torch.ops.sweep import warp_base_to_pixels
    _, _, plan, _ = _setup(cuda, EYES[0][0], True)
    channels = 5 if case == "five channels" else 2
    base = torch.rand(plan.base_shape + (channels,), device=cuda)
    if case == "float64 base":
        base = base.double()
    elif case == "bfloat16 base":
        base = base.bfloat16()
    elif case == "float64 maps":
        plan = dataclasses.replace(plan,
                                   warp_rows01=plan.warp_rows01.double(),
                                   warp_cols01=plan.warp_cols01.double())
    before = dict(warp_bilinear.launches)
    with pytest.raises(ValueError, match=match):
        warp_base_to_pixels(base.requires_grad_(), plan,
                            miss=(0.0,) * channels)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before


@pytest.mark.gpu
def test_flagship_step_runs_no_index_put_backward(cuda):
    """A profiled flagship forward+backward step (256^3 cloud, 1920x1080,
    sum of rgb^2 to the grid) runs no indexing_backward_kernel and no
    advanced-indexing autograd node: the warp's gradient is its splat."""
    from torch.profiler import ProfilerActivity, profile

    from volumetricrenderer_tpu_torch import cloud_volume, render_image
    cam, cfg, plan = _flagship_plan(cuda)
    medium = MediumConfig(combine="single", density=8.0)
    g = cloud_volume(256, 7, device=cuda).requires_grad_()

    def step():
        g.grad = None
        (render_image(g, cam, cfg, medium, plan=plan)[..., :3] ** 2).sum() \
            .backward()
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert any("_WarpBilinearBackward" in n for n in names), sorted(names)
    assert not [n for n in names
                if "indexing_backward_kernel" in n or "IndexBackward" in n
                or "IndexPutBackward" in n]
    assert bool(torch.isfinite(g.grad).all()) and \
        float(g.grad.abs().max()) > 0.0


# --- the route switch and the port's bench (volumetricrenderer_tpu_torch/
# bench.py) ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["single", "reference"])
def test_general_route_on_the_card(cuda, combine):
    """sweep_render(use_kernels=False) on a CUDA grid launches no kernel
    and calls the general sweep once; its frame and grid gradient equal the
    same call on the CPU, and the kernels' frame on the card."""
    from volumetricrenderer_tpu_torch.ops import sweep as ops_sweep
    rng = np.random.default_rng(3)
    cfg = RenderConfig(emission=True, quadrature="sliced")
    if combine == "single":
        grid, medium, scroll = rng.uniform(0.1, 1.0, (16, 16, 16)), \
            MediumConfig(combine="single", density=8.0), None
    else:
        grid, medium = rng.uniform(0.1, 1.0, (16, 16, 16, 4)), \
            MediumConfig(density=4.0)
        scroll = rng.uniform(-1.5, 1.5, (4, 3))
    cam = make_camera(CameraConfig(eye=EYES[2][0], width=96, height=64))

    def call(dev, **kw):
        def t(x):
            return None if x is None else \
                torch.tensor(x, dtype=torch.float32, device=dev)
        g = t(grid).requires_grad_()
        plan = plan_for(cam, grid.shape[:3], cfg, device=dev)
        img = ops_sweep.sweep_render(g, plan, cfg, medium, scroll=t(scroll),
                                     **kw)
        (img[..., :3] ** 2).sum().backward()
        return img.detach().cpu(), g.grad.cpu()
    before = (sum(m.launches for m in (sweep_fwd, sweep_bwd, sweep_ref_fwd,
                                       sweep_ref_bwd)),
              ops_sweep.general_calls)
    got, got_g = call(cuda, use_kernels=False)
    torch.cuda.synchronize()
    after = (sum(m.launches for m in (sweep_fwd, sweep_bwd, sweep_ref_fwd,
                                      sweep_ref_bwd)),
             ops_sweep.general_calls)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    want, want_g = call("cpu", use_kernels=False)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    _assert_grad_close(got_g, want_g)
    kern, _ = call(cuda)
    torch.testing.assert_close(kern, got, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_bench_line_on_the_card(cuda, monkeypatch, capsys):
    """The bench at 16^3 / 48x32 on the card: the gradient check passes,
    one K1 and one K2 launch per headline and bfloat16 step, the general
    sweep only on its A/B and the exit rates, the card's name and power
    limit in the line."""
    from volumetricrenderer_tpu_torch import bench
    for k, v in (("VOLT_BENCH_VOLUME", "16"), ("VOLT_BENCH_WIDTH", "48"),
                 ("VOLT_BENCH_HEIGHT", "32")):
        monkeypatch.setenv(k, v)
    assert bench.main(["--runs", "3", "--warmup", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    one = {"sweep_fwd": 1, "sweep_bwd": 1}
    assert line["grad_allclose_vs_reference"] is True
    assert line["launches_per_step"] == {"fwd_bwd": one, "bf16": one}
    assert line["general_sweep_calls"] == {"fwd_bwd": 0, "bf16": 0,
                                           "general": 4, "exit_rate": 2}
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["power_limit_w"] > 0.0 and line["peak_memory_gib"] > 0.0
    assert line["ms_per_frame_fwd_bwd"] > 0.0


GOLDEN_DEG = 180.0 * (3.0 - np.sqrt(5.0))
PLAN_ARRAYS = ("eye01", "v_grid", "u_grid", "slice_z", "seglen",
               "warp_rows01", "warp_cols01", "box_range", "box_min")
# The cameras tests/test_torch_plan.py holds the CPU's plan (EYES at 96x64
# on 16^3) or geometry (the flagship camera and 16 golden-angle config-4
# orbit cameras, radius sqrt(27), height 3, at 1920x1080 on 256^3) to the
# JAX package's with: (eye, width, height, grid size).
PLAN_CAMERAS = (
    [(eye, 96, 64, 16) for eye, _, _ in EYES]
    + [((3.0, 3.0, 3.0), 1920, 1080, 256)]
    + [((np.sqrt(18.0) * np.cos(np.radians(k * GOLDEN_DEG)),
         np.sqrt(18.0) * np.sin(np.radians(k * GOLDEN_DEG)), 3.0),
        1920, 1080, 256) for k in range(16)])


@pytest.mark.gpu
@pytest.mark.parametrize("eye,width,height,size", PLAN_CAMERAS)
def test_plan_built_on_the_card_matches_the_host_plan(cuda, eye, width,
                                                      height, size):
    """plan_for on the card against plan_for on the CPU, which
    tests/test_torch_plan.py holds to the JAX package: the same axis, sign,
    permutation and base grid, every array within atol 1e-6, and the same
    plan_base_dims; a geometry on the card adds one to
    device_geometry_calls, one on the CPU none."""
    from volumetricrenderer_tpu_torch.ops import sweep as ops_sweep
    cam = make_camera(CameraConfig(eye=tuple(eye), width=width,
                                   height=height))
    cfg = RenderConfig(emission=True, quadrature="sliced")
    shape = (size,) * 3
    calls = ops_sweep.device_geometry_calls
    host = plan_for(cam, shape, cfg, device="cpu")
    assert ops_sweep.device_geometry_calls == calls
    card = plan_for(cam, shape, cfg, device=cuda)
    assert ops_sweep.device_geometry_calls == calls + 1
    for f in ("axis", "sign", "perm", "coord_order", "identity_warp",
              "base_shape"):
        assert getattr(card, f) == getattr(host, f), f
    for f in PLAN_ARRAYS:
        got = getattr(card, f)
        assert got.device.type == "cuda" and got.dtype == torch.float32, f
        torch.testing.assert_close(got.cpu(), getattr(host, f), rtol=0,
                                   atol=1e-6, msg=f)
    assert ops_sweep.plan_base_dims(cam, shape, cfg, device=cuda) == \
        ops_sweep.plan_base_dims(cam, shape, cfg)


# --- the light sweep's scan (kernels/light_sweep.py) -----------------------

SWEEP_DIRECTIONS = [(0.5, 0.5, 1.0), (0.3, -0.2, -1.0), (1.0, 0.3, 0.2),
                    (-1.0, 0.25, -0.4), (0.2, 1.0, 0.3), (0.4, -1.0, -0.1),
                    (0.3, -0.7, 1.0), (1.0, 0.45, -0.2)]


def _swept_sigma(dev, direction, shape, density=8.0, seed=11):
    """sigma (seeded, in [0, 1.6]) permuted for the light's sweep, and the
    sweep's geometry."""
    from volumetricrenderer_tpu_torch.ops.lighting import light_sweep_geometry
    perm, sweep = light_sweep_geometry(
        LightConfig(direction=direction), RenderConfig(),
        MediumConfig(combine="single", density=density), shape)
    sigma = torch.tensor(np.random.default_rng(seed).uniform(0.0, 1.6, shape),
                         dtype=torch.float32, device=dev)
    return sigma.permute(perm).contiguous(), sweep


@pytest.mark.gpu
def test_light_sweep_kernel_bit_equal_at_config4(cuda):
    """Config 4's 256^3 FBM cloud and light: the kernel's forward equals
    the plain version on the card bit for bit (the same taps, roundings
    and exp)."""
    from volumetricrenderer_tpu_torch import cloud_volume
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    from volumetricrenderer_tpu_torch.ops.lighting import light_sweep_geometry
    sigma = cloud_volume(256, 7, device=cuda) * 0.2
    perm, sweep = light_sweep_geometry(
        LightConfig(shadow_steps=32), RenderConfig(),
        MediumConfig(combine="single", density=8.0), tuple(sigma.shape))
    sigma = sigma.permute(perm).contiguous()
    got = light_sweep.launch_kernel(sigma, sweep)
    want = light_sweep.light_sweep_reference(sigma, sweep)
    torch.cuda.synchronize()
    assert float(want.min()) < 0.5 and float(want.max()) == 1.0
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("direction", SWEEP_DIRECTIONS)
@pytest.mark.parametrize("shape", [(48, 48, 48), (24, 96, 40)])
def test_light_sweep_kernel_matches_plain_version(cuda, direction, shape):
    """Every dominant axis, both signs, oblique lights, and a grid that is
    not a cube (shifts of several texels): held to the plain version at
    tests/test_torch_lighting.py's tolerances."""
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    sigma, sweep = _swept_sigma(cuda, direction, shape)
    got = light_sweep.launch_kernel(sigma, sweep)
    want = light_sweep.light_sweep_reference(sigma, sweep)
    torch.cuda.synchronize()
    assert float(want.min()) < 0.5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("direction", [SWEEP_DIRECTIONS[0],
                                       SWEEP_DIRECTIONS[3],
                                       SWEEP_DIRECTIONS[7]])
@pytest.mark.parametrize("shape", [(48, 48, 48), (24, 96, 40),
                                   (256, 256, 256)])
def test_light_sweep_adjoint_kernel_matches_autograd(cuda, direction, shape):
    """The node's backward (the adjoint kernel) against autograd through
    the plain version, and against the adjoint's plain version; one launch
    of each kernel. 256^3 is config 4's grid, 16-row bands a CTA, with its
    light among the directions."""
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    sigma, sweep = _swept_sigma(cuda, direction, shape, density=3.0)
    dL = torch.tensor(np.random.default_rng(12).normal(size=sigma.shape),
                      dtype=torch.float32, device=cuda)
    s_ref = sigma.clone().requires_grad_()
    light_sweep.light_sweep_reference(s_ref, sweep).backward(dL)
    s = sigma.clone().requires_grad_()
    before = dict(light_sweep.launches)
    L = light_sweep.light_sweep(s, sweep)
    assert light_sweep.launches == {"forward": before["forward"] + 1,
                                    "adjoint": before["adjoint"]}
    L.backward(dL)
    torch.cuda.synchronize()
    assert light_sweep.launches == {"forward": before["forward"] + 1,
                                    "adjoint": before["adjoint"] + 1}
    scale = float(s_ref.grad.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(s.grad, s_ref.grad, rtol=BWD_TOL,
                               atol=BWD_TOL * scale)
    plain = light_sweep.light_sweep_adjoint_reference(L.detach(), dL, sweep)
    torch.testing.assert_close(s.grad, plain, rtol=BWD_TOL,
                               atol=BWD_TOL * scale)


@pytest.mark.gpu
def test_light_sweep_kernel_checks_its_inputs(cuda):
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    sigma, sweep = _swept_sigma(cuda, SWEEP_DIRECTIONS[0], (8, 8, 8))
    before = dict(light_sweep.launches)
    with pytest.raises(ValueError, match="contiguous float32"):
        light_sweep.launch_kernel(sigma.double(), sweep)
    with pytest.raises(ValueError, match="contiguous float32"):
        light_sweep.launch_kernel(sigma.transpose(1, 2), sweep)
    with pytest.raises(ValueError, match="contiguous float32"):
        light_sweep.launch_kernel(sigma, sweep, aux=sigma[:-1])
    assert light_sweep.launches == before


@pytest.mark.gpu
def test_config4_frame_sweeps_light_in_one_launch_without_gemm(cuda):
    """A profiled config-4 frame (256^3 FBM cloud, 1920x1080, shadows, the
    light volume rebuilt by render_image): one light-sweep launch, one K1
    launch, and no matrix-product kernel on the device."""
    from torch.profiler import ProfilerActivity, profile
    from volumetricrenderer_tpu_torch import cloud_volume, render_image
    from volumetricrenderer_tpu_torch.config import PRESETS
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    p = PRESETS["config4"]
    grid = cloud_volume(256, 7, device=cuda)
    cam = make_camera(p.camera)
    plan = plan_for(cam, grid.shape, p.render, device=cuda)
    render_image(grid, cam, p.render, p.medium, p.light, plan=plan)
    torch.cuda.synchronize()
    before = (dict(light_sweep.launches), sweep_fwd.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        img = render_image(grid, cam, p.render, p.medium, p.light, plan=plan)
        torch.cuda.synchronize()
    assert light_sweep.launches["forward"] == before[0]["forward"] + 1
    assert light_sweep.launches["adjoint"] == before[0]["adjoint"]
    assert sweep_fwd.launches == before[1] + 1
    assert bool(torch.isfinite(img).all())
    names = [e.key for e in prof.key_averages()]
    assert any("light_sweep_shared" in n for n in names), names
    assert not any("gemm" in n.lower() or "xmma" in n.lower()
                   for n in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("shape,shift_a,shift_b,sign", [
    ((5, 512, 512), 0.5 / 5, -0.3 / 5, 1),    # too large for shared memory
    ((9, 33, 37), -0.7 / 9, 0.45 / 9, -1),    # rows not of 16-byte pieces
    ((12, 64, 64), 2.5 / 12, 0.0, 1)])        # several texels a step
def test_light_sweep_kernel_paths(cuda, shape, shift_a, shift_b, sign):
    """The kernel's two schedules on (S, A, B) stacks given directly: the
    carry in global memory where a 512 x 512 plane overflows the cluster's
    shared memory or B is odd, in shared memory with a shift of several
    texels a step. Forward and adjoint against their plain versions, at
    the tolerances above."""
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    sweep = light_sweep.LightSweep(sign, float(np.float32(shift_a)),
                                   float(np.float32(shift_b)), 2.0 / shape[0],
                                   4.0)
    rng = np.random.default_rng(13)
    sigma = torch.tensor(rng.uniform(0.0, 1.6, shape), dtype=torch.float32,
                         device=cuda)
    dL = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                      device=cuda)
    L = light_sweep.launch_kernel(sigma, sweep)
    g = light_sweep.launch_kernel(L, sweep, aux=dL)
    want = light_sweep.light_sweep_reference(sigma, sweep)
    gwant = light_sweep.light_sweep_adjoint_reference(want, dL, sweep)
    torch.cuda.synchronize()
    assert float(want.min()) < 0.5
    torch.testing.assert_close(L, want, rtol=1e-5, atol=1e-6)
    scale = float(gwant.abs().max())
    torch.testing.assert_close(g, gwant, rtol=BWD_TOL, atol=BWD_TOL * scale)


# --- the main paths at full width -----------------------------------------
#
# Launches counted from 0 around each path; frames against the plain
# version (maps and image), steps' gradients against the plain backward on
# the launch's inputs. In bfloat16 a frame is also held to its float32 frame
# as tests/test_bf16.py holds the JAX package's (max below 3e-2, mean below
# 3e-3), and kernel to plain version within 1e-6 (maps) and 1e-5 of the
# largest gradient.

FULL = dict(width=1920, height=1080)
CONFIG4_LIGHT = LightConfig(shadow_steps=32)
BF16_MAP_LIMIT, BF16_GRAD_LIMIT = 1e-6, 1e-5


@pytest.fixture(scope="module")
def full_width():
    """The flagship cloud (cloud_volume(256, 7)) and the reference preset's
    grid (build_volume(VolumeConfig()), 128^3 x 4), built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sweep kernel has no CPU mode")
    from volumetricrenderer_tpu_torch import VolumeConfig, build_volume, \
        cloud_volume
    dev = torch.device("cuda", 0)
    return {"single": cloud_volume(256, 7, device=dev),
            "reference": build_volume(VolumeConfig(), device=dev)}


def _main_path(full_width, path):
    """(grid, medium, light, views): each view (camera, cfg, scroll) a
    frame; a step takes the first view of each emission mode."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    single = MediumConfig(combine="single", density=8.0)
    if path == "flagship":
        cams = [make_camera(CameraConfig(**FULL))] + [
            orbit_camera(t, **FULL) for t in (0.0, 0.5 * np.pi, np.pi)]
        return full_width["single"], single, None, [(c, cfg, None)
                                                    for c in cams]
    if path == "config4":  # eight orbit cameras around the full circle
        return full_width["single"], single, CONFIG4_LIGHT, [
            (orbit_camera(2.0 * np.pi * i / 8, **FULL), cfg, None)
            for i in range(8)]
    grid, cam = full_width["reference"], make_camera(CameraConfig())
    if path == "reference-orbit":
        v = torch.tensor(np.random.default_rng(11).uniform(-0.25, 0.25,
                                                           (4, 3)),
                         dtype=torch.float32, device=grid.device)
        absorb = RenderConfig(quadrature="sliced")
        return grid, MediumConfig(), None, [
            (orbit_camera(np.pi / 4 * (1 + k), width=1280, height=720),
             absorb, v * (37 * k / 60.0)) for k in range(8)]
    seeded = [_seeded_scroll(s, grid.device) for s in (5, 6)]
    if path == "reference":  # a step takes the seeded scroll, first
        scrolls = seeded[:1] + [reference_media_scroll(t, device=grid.device)
                                for t in (0.0, 1.7)] + seeded[1:]
        return grid, MediumConfig(), None, [
            (cam, RenderConfig(emission=em, quadrature="sliced"), sc)
            for em in (True, False) for sc in scrolls]
    return grid, MediumConfig(density=8.0), CONFIG4_LIGHT, [
        (cam, cfg, sc) for sc in seeded]


def _launches():
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    return (sweep_fwd.launches, sweep_bwd.launches, sweep_ref_fwd.launches,
            sweep_ref_bwd.launches, light_sweep.launches["forward"],
            light_sweep.launches["adjoint"])


def _since(before):
    """(K1, K2, K4, K5, light sweep forward, adjoint) launches since."""
    return tuple(a - b for a, b in zip(_launches(), before))


def _expect(grid, fwd, bwd, light_fwd=0, light_adj=0):
    k = (fwd, bwd, 0, 0) if grid.dim() == 3 else (0, 0, fwd, bwd)
    return k + (light_fwd, light_adj)


def _maps_both(grid, plan, cfg, medium, light, scroll, lvol, low):
    """The forward kernel's base maps and its plain version's on the same
    inputs, in float32 or (low) on bfloat16 stacks: comparison launches,
    outside every counted path."""
    lc = light if lvol is not None else None
    if grid.dim() == 4:
        L, *args = sweep_ref_fwd.sweep_ref_inputs(
            grid.permute(plan.perm + (3,)), plan, cfg, medium, lc, scroll)
        ls = None if lvol is None else sweep_ref_fwd.sweep_ref_light_slabs(
            lvol.permute(plan.perm), plan, cfg).contiguous()
        L = L.contiguous()
        L, ls = (_low(L), _low(ls)) if low else (L, ls)
        got = sweep_ref_fwd.launch_kernel(L, *args, cfg.emission, ls)
        want = sweep_ref_fwd.sweep_ref_fwd_reference(
            L, *args, emission=cfg.emission, light=ls)
    else:
        (st, *args), flip = sweep_fwd.sweep_inputs(
            grid.permute(plan.perm), plan, cfg, medium, lc)
        ls = None if lvol is None else sweep_fwd.sweep_light_stack(
            lvol.permute(plan.perm), plan, cfg).contiguous()
        st = st.contiguous()
        st, ls = (_low(st), _low(ls)) if low else (st, ls)
        got = sweep_fwd.launch_kernel(st, *args, cfg.emission, flip,
                                      cfg.address_mode == "wrap", ls)
        want = sweep_fwd.sweep_fwd_reference(
            st, *args, emission=cfg.emission, flip=flip,
            address_mode=cfg.address_mode, light=ls)
    torch.cuda.synchronize()
    return got, want


def _assert_held(img, grid, plan, cfg, medium, light, scroll, lvol, low):
    """A frame's base maps and image against the plain version's."""
    from volumetricrenderer_tpu_torch.ops.sweep import finish_image
    got, want = _maps_both(grid, plan, cfg, medium, light, scroll, lvol, low)
    with torch.no_grad():
        want_img = finish_image(want, plan, cfg, medium, light)
    for g, w, name in zip(list(got) + [img], list(want) + [want_img],
                          NAMES + ("img",)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=name)
        assert not low or float((g - w).abs().max()) <= BF16_MAP_LIMIT, name


def _assert_bf16_frame(img, f32):
    d = (img - f32).abs()
    assert 0.0 < float(d.max()) < 3e-2 and float(d.mean()) < 3e-3


def _mode(cfg, low):
    return dataclasses.replace(cfg, dtype="bfloat16") if low else cfg


def _serve_path(grid, medium, light, views, low):
    plans = [plan_for(c, grid.shape[:3], cfg, device=grid.device)
             for c, cfg, _ in views]
    sweep_ref_fwd.tiles.reset()
    before = _launches()
    frames = [render_image(grid, cam, _mode(cfg, low), medium, light,
                           scroll=sc, plan=plan)
              for (cam, cfg, sc), plan in zip(views, plans)]
    torch.cuda.synchronize()
    n = len(frames)
    assert _since(before) == _expect(grid, n, 0, n if light else 0)
    if grid.dim() == 4:  # the stage sized from the plan holds every window
        assert sweep_ref_fwd.tiles.read()[1] == 0
    held = {}  # config 4: one frame per sweep sign
    for k, plan in enumerate(plans):
        held.setdefault(plan.sign if grid.dim() == 3 and light else k, k)
    if grid.dim() == 3 and light is not None:  # the orbit's sectors
        sectors = {(p.axis, p.sign) for p in plans}
        assert {(0, -1), (0, 1), (1, -1), (1, 1)} <= sectors
        assert 2 in {a for a, _ in sectors}
    for k, ((cam, cfg, sc), plan, img) in enumerate(zip(views, plans,
                                                        frames)):
        assert img.shape == (cam.height, cam.width, 4)
        assert img.dtype == torch.float32 and bool(torch.isfinite(img).all())
        alpha = img[..., 3]
        assert 0.0 <= float(alpha.min()) and float(alpha.max()) <= 1.0
        assert float(alpha.max()) > 0.0
        f32, lvol = render_image(grid, cam, cfg, medium, scroll=sc,
                                 plan=plan), None
        if light is not None:
            lvol = light_transmittance_volume(grid, light, cfg, medium,
                                              scroll=sc)
            assert lvol.shape == grid.shape[:3]
            assert float(lvol.max()) == 1.0 and float(lvol.min()) >= 0.0
            lit, f32 = f32, render_image(grid, cam, cfg, medium, light,
                                         scroll=sc, plan=plan,
                                         light_volume=lvol)
            if not low:  # shadows keep alpha and darken rgb, somewhere
                assert float((alpha - lit[..., 3]).abs().max()) <= 1e-6
                assert bool((img[..., :3] <= lit[..., :3] + 1e-6).all())
                assert float((lit[..., :3] - img[..., :3]).max()) > 1e-3
        if low:
            _assert_bf16_frame(img, f32)
        if k in held.values():
            _assert_held(img, grid, plan, cfg, medium, light, sc, lvol, low)
    if grid.dim() == 4 and light is None:  # a seeded scroll moves the frame
        assert float((frames[0] - frames[1]).abs().max()) > 1e-3


def _step_path(grid, medium, light, views, low, seen):
    """One forward+backward step (sum of rgb^2 to the float32 grid) per
    emission mode of the views; `seen` records the backward's launches."""
    firsts = {}
    for view in views:
        firsts.setdefault(view[1].emission, view)
    lit = 0 if light is None else 1
    for cam, cfg, sc in firsts.values():
        plan = plan_for(cam, grid.shape[:3], cfg, device=grid.device)
        g = grid.clone().requires_grad_()
        sweep_ref_fwd.tiles.reset()
        seen.clear()
        before = _launches()
        img = render_image(g, cam, _mode(cfg, low), medium, light, scroll=sc,
                           plan=plan)
        loss = (img[..., :3] ** 2).sum()
        names = _autograd_names(loss)
        loss.backward()
        torch.cuda.synchronize()
        assert _since(before) == _expect(grid, 1, 1, lit, lit)
        assert len(seen) == 1 and "_WarpBilinearBackward" in names
        assert not [n for n in names
                    if "IndexBackward" in n or "IndexPutBackward" in n], names
        if grid.dim() == 4:
            assert sweep_ref_fwd.tiles.read()[1] == 0
        assert g.grad.dtype == torch.float32
        assert bool(torch.isfinite(g.grad).all())
        per_channel = g.grad.reshape(-1, grid.shape[-1] if grid.dim() == 4
                                     else 1).abs().amax(0)
        assert bool((per_channel > 0.0).all())
        a, kw, got = seen[0]
        assert a[0].dtype == (BF16 if low else torch.float32)
        if grid.dim() == 3:
            want = sweep_bwd.sweep_bwd_reference(
                *a[:11], emission=a[11], flip=a[12],
                address_mode=cfg.address_mode, **kw)
        else:
            want = sweep_ref_bwd.sweep_ref_bwd_reference(*a, **kw)
        if kw.get("light") is None:
            got, want = (got,), (want,)
        for gk, wk in zip(got, want):  # dG or dL, and the light's
            assert gk.dtype == torch.float32
            _assert_grad_close(gk, wk)
            assert not low or float((gk - wk).abs().max()) \
                <= BF16_GRAD_LIMIT * float(wk.abs().max())
        if grid.dim() == 3 and not low and light is None:
            assert torch.equal(g.grad.permute(plan.perm), got[0])
        if grid.dim() == 3 and not low and light is not None:
            g0 = grid.clone().requires_grad_()
            (render_image(g0, cam, cfg, medium, plan=plan)[..., :3] ** 2) \
                .sum().backward()
            scale = float(g0.grad.abs().max())
            assert float((g.grad - g0.grad).abs().max()) > 1e-3 * scale


def _autograd_names(t):
    """The names of the autograd nodes behind t."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo += [f for f, _ in fn.next_functions]
    return {fn.name() for fn in seen}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["serve", "step"])
@pytest.mark.parametrize("path", ["flagship", "reference", "config4",
                                  "reference-shadowed", "reference-orbit"])
def test_main_path_at_full_width(full_width, monkeypatch, path, kind,
                                 dtype):
    """The flagship (256^3 at 1920x1080: the default camera and three
    orbit cameras), the reference preset (128^3 x 4 at 1280x720, both
    emission modes, its scroll at t = 0 and 1.7 and two seeded scrolls),
    config 4 (the flagship cloud, eight orbit cameras, the light volume
    rebuilt every frame), the reference medium with shadows at density
    8 (two seeded scrolls) and the benchmark's reference.view deployment
    (the reference preset in absorption from its eight ring cameras at
    1280x720, each frame's scroll a seeded velocity times its media
    time): launches counted from 0, the frames against the plain version,
    the steps' gradients against the plain backward, no index_put_
    backward node in a step's graph."""
    grid, medium, light, views = _main_path(full_width, path)
    low = dtype == "bfloat16"
    if kind == "serve":
        return _serve_path(grid, medium, light, views, low)
    bwd_mod, seen = sweep_bwd if grid.dim() == 3 else sweep_ref_bwd, []
    launch = bwd_mod.launch_kernel

    def spy(*a, **kw):
        out = launch(*a, **kw)
        seen.append((a, {k: v for k, v in kw.items() if k != "stage"}, out))
        return out
    monkeypatch.setattr(bwd_mod, "launch_kernel", spy)
    _step_path(grid, medium, light, views, low, seen)


# --- the gradient checks against the per-ray oracle and autograd ----------

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["reference", "single shadowed",
                                  "reference shadowed", "bfloat16"])
def test_gradient_matches_the_per_ray_oracle(cuda, case):
    """bench.validate_gradients' check for the other media and modes: the
    kernels' grid gradient of sum(rgb^2) on an identity-warp plan against
    the per-ray oracle's, rtol 1e-3, atol 1e-3 * max (shadows: the light
    volume built from the grid in the loss); in bfloat16 against the float32
    oracle on the rounded grid, within 3e-3 of the largest (2^-9 a weight)."""
    from volumetricrenderer_tpu_torch import cloud_volume
    from volumetricrenderer_tpu_torch.kernels.build import bf16_round
    from volumetricrenderer_tpu_torch.ops.integrate import render_rays_sliced
    from volumetricrenderer_tpu_torch.ops.sweep import base_rays, sweep_render
    cfg = RenderConfig(emission=True, quadrature="sliced")
    light = CONFIG4_LIGHT if case.endswith("shadowed") else None
    scroll = None
    if case.startswith("reference"):
        grid = torch.tensor(np.random.default_rng(2).uniform(
            0.1, 1.0, (24, 24, 24, 4)), dtype=torch.float32, device=cuda)
        medium, scroll = MediumConfig(density=8.0), _seeded_scroll(5, cuda)
    else:
        grid = cloud_volume(24, 7, device=cuda)
        medium = MediumConfig(combine="single", density=8.0)
    if case == "bfloat16":
        grid = bf16_round(grid)
    plan = plan_for(make_camera(CameraConfig(width=48, height=32)),
                    grid.shape[:3], cfg, device=cuda)
    o, d = base_rays(plan)

    def lvol_of(g):
        return None if light is None else light_transmittance_volume(
            g, light, cfg, medium, scroll=scroll)
    g1, g2 = grid.clone().requires_grad_(), grid.clone().requires_grad_()
    (sweep_render(g1, dataclasses.replace(plan, identity_warp=True),
                  _mode(cfg, case == "bfloat16"), medium, light,
                  scroll=scroll, light_volume=lvol_of(g1))[..., :3] ** 2) \
        .sum().backward()
    (render_rays_sliced(g2, o, d, plan, cfg, medium, light, scroll=scroll,
                        light_volume=lvol_of(g2))[..., :3] ** 2).sum() \
        .backward()
    assert g1.grad.dtype == torch.float32
    if case == "bfloat16":
        scale = float(g2.grad.abs().max())
        assert 0.0 < float((g1.grad - g2.grad).abs().max()) <= 3e-3 * scale
    else:
        _assert_grad_close(g1.grad, g2.grad, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", [None, "pushed"], ids=["unlit", "lit"])
@pytest.mark.parametrize("combine", ["single", "reference"])
@pytest.mark.parametrize("eye", [e for e, _, _ in EYES])
def test_plain_backward_matches_autograd_on_the_card(cuda, eye, combine,
                                                     kind, dtype):
    """The plain backward, the kernels' yardstick, against autograd of the
    plain forward on the card, without and with a light volume stretched
    past [0, 1], in float32 and bfloat16 (autograd on float32 copies of the
    bfloat16 stacks, _low=True, so that it does not round the gradient)."""
    scroll = None
    if combine == "single":
        grid, cfg, plan, medium = _setup(cuda, eye, True)
        (stack, *args), flip = sweep_fwd.sweep_inputs(
            grid.permute(plan.perm), plan, cfg, medium,
            LIGHT if kind else None)
        kw = dict(emission=True, flip=flip, address_mode="mirror")
        fwd, bwd, slabs = sweep_fwd.sweep_fwd_reference, \
            sweep_bwd.sweep_bwd_reference, sweep_fwd.sweep_light_stack
    else:
        grid, cfg, plan, _, _ = _ref_setup(cuda, eye, True)
        medium = MediumConfig(combine="reference", density=8.0)
        scroll = _scroll("random", cuda)
        stack, *args = sweep_ref_fwd.sweep_ref_inputs(
            grid.permute(plan.perm + (3,)), plan, cfg, medium,
            LIGHT if kind else None, scroll)
        kw = dict(emission=True)
        fwd, bwd, slabs = sweep_ref_fwd.sweep_ref_fwd_reference, \
            sweep_ref_bwd.sweep_ref_bwd_reference, \
            sweep_ref_fwd.sweep_ref_light_slabs
    light = None if kind is None else slabs(_light_volume(
        grid, cfg, medium, kind, scroll).permute(plan.perm), plan,
        cfg).contiguous()
    stack, low = stack.contiguous(), dtype == "bfloat16"
    if low:
        stack, light = _low(stack), _low(light)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=plan.base_shape), dtype=torch.float32,
                        device=cuda) for _ in range(3)]
    st = stack.to(torch.float32).requires_grad_()
    lt = None if light is None else light.to(torch.float32).requires_grad_()
    maps = fwd(st, *args, light=lt, **kw, **({"_low": True} if low else {}))
    auto = torch.autograd.grad(sum((m * c).sum() for m, c in zip(maps[:3],
                                                                cts)),
                               (st,) if lt is None else (st, lt))
    own = bwd(stack, *args, *cts, maps[1].detach(), maps[2].detach(),
              light=light, **kw)
    for g, w in zip((own,) if light is None else own, auto):
        _assert_grad_close(g, w)


# --- the preset front end on the card -------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4",
                                  "reference"])
def test_cli_render_preset_on_the_card(cuda, name, tmp_path):
    """`cli render --preset NAME` at the preset's size: config1-4 launch K1
    once, `reference` (the per-ray march) nothing; the PNG and
    render_preset's frame are render_image's on the same grid; a sliced
    preset's maps and frame are the plain version's at its own shapes;
    config2 also in bfloat16 through render_preset, one K1 launch."""
    from volumetricrenderer_tpu_torch import PRESETS, build_volume, cli, \
        render_preset
    from volumetricrenderer_tpu_torch.models import scene as scene_mod
    from volumetricrenderer_tpu_torch.utils.image import encode_png
    p, out = PRESETS[name], tmp_path / f"{name}.png"
    sliced = p.render.quadrature == "sliced"
    before = _launches()
    assert cli.main(["render", "--preset", name, "--out", str(out)]) == 0
    torch.cuda.synchronize()
    assert _since(before)[:4] == ((1, 0, 0, 0) if sliced else (0, 0, 0, 0))
    cam = make_camera(p.camera)
    with torch.no_grad():
        if p.scene:
            grid, scroll = scene_mod.bake_scene(
                getattr(scene_mod, p.scene)(p.volume.size, device=cuda),
                p.volume.size, p.render), None
        else:
            grid = build_volume(p.volume, device=cuda)
            scroll = reference_media_scroll(0.0, n_channels=grid.shape[-1],
                                            device=cuda)
        want = render_image(grid, cam, p.render, p.medium, p.light,
                            scroll=scroll)
        again = render_preset(p, grid=None if p.scene else grid,
                              device=cuda)
    assert want.shape == (p.camera.height, p.camera.width, 4)
    assert bool(torch.isfinite(want).all()) and float(want[..., 3].max()) > 0
    assert torch.equal(again, want)
    assert out.read_bytes() == encode_png(want)
    if not sliced:
        return
    g3 = grid[..., 0] if grid.dim() == 4 else grid
    plan = plan_for(cam, g3.shape, p.render, device=cuda)
    with torch.no_grad():
        lvol = light_transmittance_volume(g3, p.light, p.render, p.medium) \
            if p.render.emission and p.light.shadow_steps > 0 else None
        _assert_held(want, g3, plan, p.render, p.medium, p.light, None, lvol,
                     False)
        if name == "config2":
            before = _launches()
            img = render_preset(dataclasses.replace(
                p, render=_mode(p.render, True)), grid=grid, device=cuda)
            torch.cuda.synchronize()
            assert _since(before)[:4] == (1, 0, 0, 0)
            _assert_bf16_frame(img, want)
            _assert_held(img, g3, plan, p.render, p.medium, p.light, None,
                         lvol, True)


@pytest.mark.gpu
def test_a_second_process_loads_the_built_libraries(cuda):
    """A process started after the libraries were built loads them (their
    names carry the sources' key) and builds none."""
    import subprocess
    import sys
    from volumetricrenderer_tpu_torch.kernels import light_sweep
    mods = (sweep_fwd, sweep_bwd, sweep_ref_fwd, sweep_ref_bwd, light_sweep)
    paths = [m.build_kernel()["path"] for m in mods]
    code = ("from volumetricrenderer_tpu_torch.kernels import light_sweep, "
            "sweep_bwd, sweep_fwd, sweep_ref_bwd, sweep_ref_fwd\n"
            "for m in (sweep_fwd, sweep_bwd, sweep_ref_fwd, sweep_ref_bwd, "
            "light_sweep):\n    i = m.build_kernel()\n"
            "    print(i['path'], i['seconds'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert [line.split() for line in out.splitlines()] == \
        [[p, "0.0"] for p in paths]


@pytest.mark.gpu
def test_cli_serve_reference_preset_sliced_on_the_card(cuda, capsys):
    """`cli serve --preset reference --quadrature sliced` at the preset's
    size: every served frame one K4 launch, no K1, no general sweep."""
    import socket
    from volumetricrenderer_tpu_torch import cli
    from volumetricrenderer_tpu_torch.ops import sweep
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    before, general = _launches(), sweep.general_calls
    assert cli.main(["serve", "--preset", "reference", "--quadrature",
                     "sliced", "--selftest-frames", "4", "--port",
                     str(port)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert (report["width"], report["height"]) == (1280, 720)
    k1, k2, k4, k5, _, _ = _since(before)
    assert (k1, k2, k5) == (0, 0, 0) and k4 >= report["final_state"]["frames"]
    assert sweep.general_calls == general


@pytest.mark.gpu
def test_cli_info_on_the_card(cuda, capsys):
    from volumetricrenderer_tpu_torch import cli
    assert cli.main(["info"]) == 0
    assert torch.cuda.get_device_name(0) in capsys.readouterr().out


# --- two ranks sharing the one card ---------------------------------------
#
# NCCL refuses two ranks on one device; on that refusal alone the ranks run
# on gloo (CUDA maps exchanged through host copies, parallel/mesh.py).

SHARED_CARD_RANKS, SHARED_CARD_TIMEOUT_S = 2, 240
NCCL_REFUSAL = "Duplicate GPU detected"


def _shared_card_rank(rank, world, backend, init_file, out_file):
    """One rank of a (1, world) mesh on cuda:0: config 5's frame (512^3,
    1080p) and its gradient to the rank's slab block; rank 0 holds them to
    the unsharded kernels' (early stop off: 2e-4, 1e-3 of the largest)."""
    import torch.distributed as dist

    from volumetricrenderer_tpu_torch import build_volume, get_preset
    from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import \
        sweep_render_sharded
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        if backend == "nccl":
            dist.all_reduce(torch.ones(4, device=dev))
            torch.cuda.synchronize()
        mesh = make_mesh(1, world, device="cuda" if backend == "nccl"
                         else "cpu")
        p = get_preset("config5")
        cfg = dataclasses.replace(p.render, early_stop_transmittance=-1.0)
        grid = build_volume(p.volume, device=dev)[..., 0]
        torch.cuda.empty_cache()
        cam = make_camera(p.camera)
        plan = plan_for(cam, grid.shape, cfg, device=dev)
        depth = grid.shape[0] // world
        block = grid[rank * depth:(rank + 1) * depth].clone() \
            .requires_grad_()
        before = (sweep_fwd.launches, sweep_bwd.launches)
        img = sweep_render_sharded(block, plan, mesh, cfg, p.medium)
        (img[..., :3] ** 2).sum().backward()
        torch.cuda.synchronize()
        rows = [None] * world
        dist.all_gather_object(rows, (sweep_fwd.launches - before[0],
                                      sweep_bwd.launches - before[1]))
        if rank == 0:
            g = grid.clone().requires_grad_()
            want = render_image(g, cam, cfg, p.medium, plan=plan)
            (want[..., :3] ** 2).sum().backward()
            scale = float(g.grad.abs().max())
            res = {"launches": rows, "image_ok": bool(torch.allclose(
                img.detach(), want.detach(), rtol=2e-4, atol=2e-4)),
                "grad_ok": scale > 0 and bool(torch.allclose(
                    block.grad, g.grad[:depth], rtol=1e-3,
                    atol=1e-3 * scale))}
            with open(out_file, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _run_shared_card(backend, tmp):
    """(rank 0's result or None, the error text or None)."""
    import os
    import time

    import torch.multiprocessing as mp
    out_file = os.path.join(tmp, f"out-{backend}.json")
    ctx = mp.start_processes(
        _shared_card_rank, args=(SHARED_CARD_RANKS, backend,
                                 os.path.join(tmp, f"init-{backend}"),
                                 out_file),
        nprocs=SHARED_CARD_RANKS, join=False, start_method="spawn")
    deadline = time.perf_counter() + SHARED_CARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                return None, f"no result after {SHARED_CARD_TIMEOUT_S} s"
    except Exception as e:  # a rank raised: its traceback is the message
        return None, str(e)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    with open(out_file) as f:
        return json.load(f), None


@pytest.mark.gpu
def test_two_ranks_share_the_card(cuda, tmp_path):
    """Two ranks spawned on cuda:0 render config 5's frame and its
    gradient through the slab-sharded sweep, one K1 and one K2 launch
    each, equal to the unsharded kernels'."""
    torch.cuda.empty_cache()
    res, err = _run_shared_card("nccl", str(tmp_path))
    if res is None:
        assert NCCL_REFUSAL in err, err
        res, err = _run_shared_card("gloo", str(tmp_path))
        assert res is not None, err
    assert [tuple(r) for r in res["launches"]] == \
        [(1, 1)] * SHARED_CARD_RANKS
    assert res["image_ok"] and res["grad_ok"], res


# --- the runners on the card ----------------------------------------------

# Each runner's main() at its CPU test's size (tests/test_torch_tools.py,
# tests/test_torch_runners.py): (environment, arguments). The sharded ones
# on one rank: multichip spawns it (NCCL), sharded_step (without its 512
# phase) and scaling_rehearsal run it in this process, as under torchrun.
IN_PLACE, SPAWNED = ("sharded_step", "scaling_rehearsal"), ("multichip",)
RUNNER_RUNS = {
    "fit_config3": ({"VOLT_F_SIZE": "12", "VOLT_F_IMG": "24",
                     "VOLT_F_STEPS": "3"}, []),
    "anim_config4": ({"VOLT_A_FRAMES": "3", "VOLT_A_VOLUME": "16",
                      "VOLT_A_WIDTH": "48", "VOLT_A_HEIGHT": "32"}, []),
    "scale512": ({"VOLT_S_FRAMES": "1", "VOLT_S_SLICES": "16,8",
                  "VOLT_S_VOLUME": "16", "VOLT_S_WIDTH": "48",
                  "VOLT_S_HEIGHT": "32"}, []),
    "serve_local": ({"VOLT_SL_SIZE": "48", "VOLT_SL_K": "4",
                     "VOLT_SL_ITERS": "1", "VOLT_SL_VOLUME": "16"}, []),
    "measure_warp": ({"VOLT_W_FRAMES": "2", "VOLT_W_ITERS": "1",
                      "VOLT_W_VOLUME": "16", "VOLT_W_WIDTH": "48",
                      "VOLT_W_HEIGHT": "32"}, []),
    "trace_flagship": ({"V": "16", "W": "48", "H": "32", "K": "2"}, []),
    "multichip": ({}, ["--ranks", "1"]),
    "sharded_step": ({"VOLT_SH_VOLUME": "16", "VOLT_SH_WIDTH": "32",
                      "VOLT_SH_HEIGHT": "32", "VOLT_SH_ITERS": "1",
                      "VOLT_SH_512": "0"}, ["--ranks", "1"]),
    "scaling_rehearsal": ({"V": "16", "IMG": "32", "STEPS": "2",
                           "VOLT_SR_SHAPES": "1x1"}, []),
    "profile_parts": ({"V": "16", "W": "48", "H": "32", "K": "1",
                       "I": "1"}, []),
}


def _k(launches):
    """A line's launches dict as (K1, K2, K4, K5)."""
    return tuple(launches[k] for k in ("sweep_fwd", "sweep_bwd",
                                       "sweep_ref_fwd", "sweep_ref_bwd"))


# The keys of each runner's line beyond device, power_limit_w, timed_runs,
# launches and general_sweep_calls.
RUNNER_KEYS = {
    "fit_config3": "loss_first loss_last loss_drop_x losses_every_5 losses "
                   "skipped_steps fit_s ms_per_step host_ms_per_step setup_s",
    "anim_config4": "frames fps_wall ms_per_frame_wall ms_per_frame "
                    "mrays_per_s plan_s setup_s warmup_runs",
    "scale512": "by_slices base_shape ms_per_frame_fwd ms_per_frame_fwd_bwd "
                "mrays_per_s_fwd_bwd peak_memory_gib warmup_runs",
    "serve_local": "states iters init_s plan_build_s ms_per_frame_device "
                   "fps_device_paced ms_per_round_all warmup_runs",
    "measure_warp": "base_shape moveaxis_only ms_fwd ms_fwd_bwd pixels "
                    "footprint_pixels",
    "trace_flagship": "wall_ms_per_step busy_ms_per_step idle_share top_ops "
                      "warmup_runs",
    "multichip": "n_devices mesh loss ok launches_per_rank total_s",
    "sharded_step": "ms_per_frame host_ms_per_frame launches_per_rank "
                    "base_fwd_sharded_vs_unsharded full_fwd_sharded_vs_"
                    "unsharded full_fwdbwd_sharded_vs_unsharded "
                    "fwd_max_abs_diff train_step_losses train_loss_ratio "
                    "train_6steps_s launches_per_variant launches_train "
                    "ranks warmup_runs total_s",
    "scaling_rehearsal": "volume image base_shape steps_timed shapes "
                         "launches_per_rank total_s",
    "profile_parts": "ms_per_frame host_ms_per_frame launches_per_stage "
                     "base_shape slices warmup_runs total_s",
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(RUNNER_RUNS))
def test_runner_main_on_the_card(cuda, name, monkeypatch, capsys):
    """Each runner's main() on the card: its line's keys and card; no K4 or
    K5 (the runners render the single-channel medium); the line's general
    sweep calls are the counter's; its K1/K2 launches, those of its timed
    runs, at most the counters' (equal where the line counts the whole run
    in place; a spawned rank's, above 0, where this process launched
    none)."""
    import importlib

    from volumetricrenderer_tpu_torch.ops import sweep as ops_sweep
    env, argv = RUNNER_RUNS[name]
    if name in IN_PLACE:
        env = {**env, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls, before = ops_sweep.general_calls, _launches()
    assert importlib.import_module(
        f"volumetricrenderer_tpu_torch.tools.{name}").main(argv) == 0
    torch.cuda.synchronize()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = ("device power_limit_w timed_runs launches general_sweep_calls "
            + RUNNER_KEYS[name]).split()
    assert not [k for k in keys if k not in line]
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["general_sweep_calls"] == ops_sweep.general_calls - calls
    here, in_line = _since(before)[:4], _k(line["launches"])
    assert here[2:] == (0, 0) and in_line[2:] == (0, 0)
    if name in SPAWNED:
        assert here == (0, 0, 0, 0) and in_line[0] > 0
    elif name in IN_PLACE:
        assert here == in_line
    else:
        assert all(h >= n for h, n in zip(here, in_line)), (here, in_line)


# --- fit_grid's optimizer step: Adam and the clamp (kernels/adam_clamp.py) --

ADAM_LR = 5e-2


def _adam_grid(shape, offset, gen):
    """A seeded uniform [0, 1) float32 grid as a leaf on the card; offset
    1 makes it a view 4 bytes into its storage, so no pointer of it is
    16-byte aligned."""
    n = int(np.prod(shape))
    buf = torch.empty(n + offset, device=gen.device)
    grid = buf[offset:].view(shape)
    grid.copy_(torch.rand(shape, generator=gen, device=gen.device))
    return grid.detach().requires_grad_()


def _adam_grad(shape, offset, gen):
    """Seeded gradients over several decades (some voxels move by about
    the learning rate, the clamp acts), laid out as _adam_grid's."""
    g = torch.randn(shape, generator=gen, device=gen.device) * torch.exp(
        3.0 * torch.randn(shape, generator=gen, device=gen.device) - 4.0)
    buf = torch.empty(g.numel() + offset, device=gen.device)
    return buf[offset:].view(shape).copy_(g)


def _adam_equal(got, want, what):
    """Bit for bit, a NaN where the other has one: the kernel keeps torch's
    order of operations and its rounding of each."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                               msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
@pytest.mark.parametrize("shape", [(256,) * 3, (512,) * 3, (37, 41, 43)],
                         ids=["256", "512", "odd"])
def test_adam_clamp_kernel_matches_plain_version(cuda, shape, layout):
    """adam_clamp_step's kernel against its plain version (torch.optim.Adam
    on the card, torch's foreach path, then clamp_) on the same grid and
    gradients: grid, moments and step equal bit for bit after 1 and 10
    steps; the float4 path (aligned) and the scalar path (a grid and
    gradient 4 bytes into their storage); the odd numel exercises the
    float4 path's tail, and a NaN in its first gradient stays NaN."""
    from volumetricrenderer_tpu_torch.kernels import adam_clamp
    torch.cuda.empty_cache()
    offset = 1 if layout == "unaligned" else 0
    gen = torch.Generator(device=cuda).manual_seed(11)
    got = _adam_grid(shape, offset, gen)
    assert (got.data_ptr() % 16 == 0) == (offset == 0)
    want = got.detach().clone().requires_grad_()
    opt_got = torch.optim.Adam([got], lr=ADAM_LR)
    opt_want = torch.optim.Adam([want], lr=ADAM_LR)
    before = adam_clamp.launches
    for step in range(1, 11):
        got.grad = _adam_grad(shape, offset, gen)
        if shape == (37, 41, 43) and step == 1:
            got.grad.view(-1)[[5, 4 * (got.numel() // 4) + 1]] = float("nan")
        want.grad = got.grad.clone()
        adam_clamp.adam_clamp_step(opt_got, got, 0.0, 1.0)
        adam_clamp.adam_clamp_reference(opt_want, want, 0.0, 1.0)
        if step in (1, 10):
            torch.cuda.synchronize()
            _adam_equal(got.detach(), want.detach(), f"grid, step {step}")
            for k in ("exp_avg", "exp_avg_sq"):
                _adam_equal(opt_got.state[got][k], opt_want.state[want][k],
                            f"{k}, step {step}")
            assert float(opt_got.state[got]["step"]) == step
            assert opt_got.state[got]["step"].device.type == "cpu"
    assert adam_clamp.launches == before + 10
    assert bool(((got == 0.0) | (got == 1.0)).any())  # the clamp acted
    if shape == (37, 41, 43):
        assert int(torch.isnan(got).sum()) == 2


@pytest.mark.gpu
def test_fit_grid_launches_the_adam_kernel_per_applied_step(cuda,
                                                             monkeypatch):
    """fit_grid on the card: one adam_clamp launch per applied step and
    none on a step the NaN guard skips; torch's global optimizer-step post
    hook sees each applied step and the grid. A plain-path run fed the
    same gradients (torch.optim.Adam and clamp_ on a shadow grid, step by
    step) holds the same grid before every step and ends with the same
    leaves, bit for bit."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from volumetricrenderer_tpu_torch import fit as tfit
    from volumetricrenderer_tpu_torch.kernels import adam_clamp
    from volumetricrenderer_tpu_torch.utils.checkpoint import \
        adam_state_to_leaves
    shadow = {}
    real = tfit.adam_clamp_step

    def replayed(optimizer, grid, lo, hi):
        if not shadow:
            shadow["grid"] = grid.detach().clone().requires_grad_()
            shadow["opt"] = torch.optim.Adam([shadow["grid"]], lr=ADAM_LR)
        _adam_equal(grid.detach(), shadow["grid"].detach(), "grid")
        shadow["grid"].grad = grid.grad.clone()
        adam_clamp.adam_clamp_reference(shadow["opt"], shadow["grid"], lo,
                                        hi)
        real(optimizer, grid, lo, hi)

    monkeypatch.setattr(tfit, "adam_clamp_step", replayed)
    target = np.random.default_rng(4).uniform(0.0, 0.5, (24, 32, 3)).astype(
        np.float32)
    args = (make_camera(CameraConfig(width=32, height=24)),
            RenderConfig(emission=True, quadrature="sliced"),
            MediumConfig(combine="single", density=8.0))
    saved, hooked = [], []
    handle = register_optimizer_step_post_hook(
        lambda opt, a, k: hooked.append(opt.param_groups[0]["params"][0]))
    before = adam_clamp.launches
    try:
        res = tfit.fit_grid(target, *args, grid_size=12, steps=4,
                            learning_rate=ADAM_LR, checkpoint_every=4,
                            checkpoint_fn=lambda s, g, st: saved.append(st))
    finally:
        handle.remove()
    torch.cuda.synchronize()
    assert res.skipped_steps == 0 and adam_clamp.launches == before + 4
    # four from the fit's steps, four from the shadow's optimizer.step()
    assert len(hooked) == 8
    assert hooked[1].data_ptr() == res.grid.data_ptr()
    _adam_equal(res.grid, shadow["grid"].detach(), "final grid")
    for got, want in zip(saved[0], adam_state_to_leaves(shadow["opt"],
                                                        shadow["grid"])):
        np.testing.assert_array_equal(got, want)
    target[3, 5, 1] = np.nan
    res = tfit.fit_grid(target, *args, grid_size=12, steps=2,
                        learning_rate=ADAM_LR)
    assert res.skipped_steps == 2 and adam_clamp.launches == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("writer", ["kernel", "cpu"])
def test_adam_checkpoint_crosses_kernel_and_cpu_paths(cuda, writer,
                                                       tmp_path):
    """Three steps on one path (the kernel on the card, or the plain
    version on the CPU), a checkpoint, a restore on the other path: the
    restored state's leaves equal the checkpoint's bit for bit, and two
    more steps there follow the writer's own two more steps. CPU and card
    round some products apart (torch's CPU addcmul multiplies in another
    order), so those are held at rtol 1e-5 with atol 1e-7 on the grid and
    1e-6 of the largest on the moments; a wrong step moves a voxel by about
    the learning rate, 5e-2."""
    from volumetricrenderer_tpu_torch.kernels import adam_clamp
    from volumetricrenderer_tpu_torch.utils import checkpoint as ck
    shape = (9, 10, 11)
    gen = torch.Generator(device=cuda).manual_seed(5)
    grads = [_adam_grad(shape, 0, gen) for _ in range(5)]
    start = _adam_grid(shape, 0, gen)
    dev_w, dev_r = (cuda, "cpu") if writer == "kernel" else ("cpu", cuda)

    def path(device, grid=None, leaves=None):
        p = (start if grid is None else torch.as_tensor(grid)).detach() \
            .to(device).clone().requires_grad_()
        opt = torch.optim.Adam([p], lr=ADAM_LR)
        if leaves is not None:
            opt.state[p] = ck.adam_state_from_leaves(leaves, p)
        return p, opt

    def steps(p, opt, gs):
        for g in gs:
            p.grad = g.to(p.device)
            adam_clamp.adam_clamp_step(opt, p, 0.0, 1.0)

    p_w, opt_w = path(dev_w)
    before = adam_clamp.launches
    steps(p_w, opt_w, grads[:3])
    ck.save_checkpoint(str(tmp_path), 3, p_w.detach(),
                       ck.adam_state_to_leaves(opt_w, p_w))
    step, grid, leaves, _ = ck.restore_checkpoint(
        str(tmp_path), opt_state_template=ck.adam_initial_leaves(shape))
    assert step == 3 and int(leaves[0]) == 3
    p_r, opt_r = path(dev_r, grid, leaves)
    for got, want in zip(ck.adam_state_to_leaves(opt_r, p_r), leaves):
        np.testing.assert_array_equal(got, want)
    steps(p_r, opt_r, grads[3:])
    steps(p_w, opt_w, grads[3:])
    assert adam_clamp.launches == before + (5 if writer == "kernel" else 2)
    torch.testing.assert_close(p_r.detach().cpu(), p_w.detach().cpu(),
                               rtol=1e-5, atol=1e-7)
    for k in ("exp_avg", "exp_avg_sq"):
        a, b = opt_r.state[p_r][k].cpu(), opt_w.state[p_w][k].cpu()
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()), msg=k)
    assert float(opt_r.state[p_r]["step"]) == 5.0
