"""The reference against the port at a tiny size on the CPU, where the
port runs its kernels' plain versions: the plan, the light volume, the
frame with and without it, the gradient and a fit step; and the control
(TF32) visibly apart from both."""
import pytest
import torch

from benchmark import plan as bplan
from benchmark import reference, scene

MED = {"density": 8.0, "sample_scale": 0.2, "early_stop_transmittance": 1e-3,
       "ambient": 0.1, "light_color": [1.0, 1.0, 1.0],
       "background": [0.0, 0.0, 0.0], "light_direction": [0.5, 0.5, 1.0]}
CAMS = [{"eye": eye, "center": [0.0, 0.0, 0.0], "up": [0.0, 0.0, 1.0],
         "fov_y_degrees": 45.0, "width": 32, "height": 24}
        for eye in ([3.0, 3.0, 3.0], [-4.2, 0.7, 3.0], [0.5, -4.1, -3.0])]


def _port(cam, grid, light=False):
    from volumetricrenderer_tpu_torch.config import (LightConfig,
                                                     MediumConfig,
                                                     RenderConfig)
    from volumetricrenderer_tpu_torch.ops.camera import look_at_camera
    from volumetricrenderer_tpu_torch.render import plan_for
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    lc = LightConfig(shadow_steps=32 if light else 0)
    pcam = look_at_camera(cam["eye"], cam["center"], cam["up"],
                          cam["fov_y_degrees"], cam["width"], cam["height"])
    return plan_for(pcam, grid.shape, cfg, device="cpu"), cfg, medium, lc, \
        pcam


@pytest.fixture(scope="module")
def grid():
    return scene.make_grid({"kind": "cloud", "size": 16}, 2**31 + 77, "cpu")


@pytest.mark.parametrize("cam", CAMS)
def test_plan_matches_the_port(cam, grid):
    p, *_ = _port(cam, grid)
    mine = bplan.make_plan(cam, grid.shape, "cpu")
    for key, theirs in (("eye01", p.eye01), ("v_grid", p.v_grid),
                        ("u_grid", p.u_grid), ("slice_z", p.slice_z),
                        ("seglen", p.seglen), ("rows01", p.warp_rows01),
                        ("cols01", p.warp_cols01)):
        assert torch.equal(mine[key], theirs), key
    assert (mine["sign"], tuple(mine["perm"])) == (p.sign, tuple(p.perm))


@pytest.mark.parametrize("light", [False, True])
@pytest.mark.parametrize("cam", CAMS)
def test_frame_matches_the_port(cam, light, grid):
    from volumetricrenderer_tpu_torch.ops.lighting import \
        light_transmittance_volume
    from volumetricrenderer_tpu_torch.render import render_image
    p, cfg, medium, lc, pcam = _port(cam, grid, light)
    lv = light_transmittance_volume(grid, lc, cfg, medium) if light else None
    theirs = render_image(grid, pcam, cfg, medium, lc, plan=p,
                          light_volume=lv)
    lv_ref = reference.light_volume(grid, MED) if light else None
    if light:
        torch.testing.assert_close(lv_ref, lv, rtol=1e-6, atol=1e-7)
    ref = reference.render(grid, bplan.make_plan(cam, grid.shape, "cpu"),
                           MED, lv_ref)
    torch.testing.assert_close(ref, theirs, rtol=1e-6, atol=1e-7)
    ctl = reference.render(grid, bplan.make_plan(cam, grid.shape, "cpu"),
                           MED, reference.light_volume(grid, MED, tf32=True)
                           if light else None, tf32=True)
    err = float((ctl - ref).norm() / ref.norm())
    assert err > 1e-6


def test_gradient_matches_the_port(grid):
    from volumetricrenderer_tpu_torch.ops.sweep import sweep_render
    cam = CAMS[0]
    p, cfg, medium, lc, _ = _port(cam, grid)
    target = torch.rand((24, 32, 3), generator=torch.Generator().manual_seed(
        5))
    g1 = grid.clone().requires_grad_(True)
    torch.mean((sweep_render(g1, p, cfg, medium, lc)[..., :3] - target) ** 2
               ).backward()
    g2 = grid.clone().requires_grad_(True)
    loss = torch.mean((reference.render(
        g2, bplan.make_plan(cam, grid.shape, "cpu"), MED)[..., :3]
        - target) ** 2)
    grad, = torch.autograd.grad(loss, g2)
    torch.testing.assert_close(grad, g1.grad, rtol=1e-5, atol=1e-9)


def test_fit_steps_match_the_port(grid):
    from volumetricrenderer_tpu_torch.fit import fit_grid
    cam = CAMS[0]
    p, cfg, medium, lc, pcam = _port(cam, grid)
    plan = bplan.make_plan(cam, grid.shape, "cpu")
    with torch.no_grad():
        target = reference.render(grid, plan, MED)[..., :3].contiguous()
    res = fit_grid(target, pcam, cfg, medium, lc, grid_size=16, steps=3,
                   learning_rate=0.05)
    losses, _, change = reference.fit_steps(target, plan, MED, 16, 0.05, 3)
    assert res.losses == pytest.approx(losses, rel=1e-6)
    torch.testing.assert_close(res.grid - 0.1, change, rtol=1e-5, atol=1e-6)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -0.1, 0.0])
    r = reference.tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie rounds to even
    assert r[2] == 1.0 + 2 ** -9
    assert abs(float(r[3]) + 0.1) < 2 ** -11 * 0.1 and r[4] == 0.0
