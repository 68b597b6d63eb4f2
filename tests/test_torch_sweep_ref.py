"""The 4-channel reference-combine sweep of the port (kernels/sweep_ref_fwd.py,
kernels/sweep_ref_bwd.py: the plain PyTorch versions of the K4/K5 CUDA
kernels) against the JAX package on the same grid, plan and scroll:

* the jnp sweep `_sweep_base`,
* K4 and K5, the Pallas kernels `_fwd_kernel_ref` / `_bwd_kernel_ref`,
  through `sweep_base_pallas_ref(..., interpret=True)`.

The preset's own scroll, reference_media_scroll(t), moves nothing: it puts
(-t, 0, 0) in channel 0's row, whose scroll weight is 0. So every offset
check also runs a seeded (4, 3) scroll with entries in [-1.5, 1.5], which
moves all three coordinates of channels 1-3.

Forward tolerance rtol=2e-4, atol=2e-5 and gradient tolerance rtol=2e-3,
atol=2e-3 * max|grad| are the ones tests/test_sweep_pallas_ref.py holds the
Pallas kernels to. The CUDA kernels themselves are held against the plain
versions by tests/test_torch_gpu.py (skipped without a card) and by
chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sweep_fwd import torch_plan
from volumetricrenderer_tpu.config import CameraConfig as JCameraConfig
from volumetricrenderer_tpu.config import MediumConfig as JMedium
from volumetricrenderer_tpu.config import RenderConfig as JRender
from volumetricrenderer_tpu.kernels import sweep_pallas as sp
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.integrate import \
    reference_media_scroll as jscroll
from volumetricrenderer_tpu.ops.sweep import _sweep_base, plan_sweep
from volumetricrenderer_tpu.ops.sweep import sweep_render as jsweep_render
from volumetricrenderer_tpu_torch.config import LightConfig, MediumConfig, \
    RenderConfig
from volumetricrenderer_tpu_torch.kernels import build, sweep_fwd, \
    sweep_ref_bwd, sweep_ref_fwd
from volumetricrenderer_tpu_torch.ops.integrate import reference_media_scroll
from volumetricrenderer_tpu_torch.ops.sweep import sweep_render

torch.set_num_threads(1)

D = 16
RTOL, ATOL = 2e-4, 2e-5
GRAD_TOL = 2e-3
NAMES = ("acc", "trans", "wsum", "hit")

# One eye per sweep axis, as tests/test_sweep_pallas_ref.py picks them.
AXIS_EYES = [((-3.0, 2.5, 2.0), 0), ((2.0, -3.2, 2.4), 1),
             ((1.5, 2.0, 3.4), 2)]
SCROLLS = ["none", "preset", "random"]


def _scroll(kind):
    """(4, 3) float32 numpy scroll, or None."""
    if kind == "none":
        return None
    if kind == "preset":
        return np.array(jscroll(1.7))
    return np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)


def _setup(emission, eye=(3.0, 3.0, 3.0), seed=0, density=1.0,
           n_slices=None):
    grid = np.random.default_rng(seed).uniform(0.1, 1.0, (D, D, D, 4)) \
        .astype(np.float32)
    jcfg = JRender(emission=emission, quadrature="sliced",
                   address_mode="mirror")
    jplan = plan_sweep(make_camera(JCameraConfig(eye=eye, width=96,
                                                 height=64)),
                       grid.shape, jcfg, n_slices=n_slices)
    tcfg = RenderConfig(emission=emission, quadrature="sliced",
                        address_mode="mirror")
    return (grid, jcfg, jplan, JMedium(combine="reference", density=density),
            tcfg, torch_plan(jplan),
            MediumConfig(combine="reference", density=density))


def _jnp_base(grid, jplan, jcfg, jmed, scroll):
    gperm = jnp.transpose(jnp.asarray(grid), jplan.perm + (3,))
    return _sweep_base(gperm, None, jplan.slice_z, jplan.v_grid,
                       jplan.u_grid, jplan.seglen, jplan, jcfg, jmed, None,
                       None if scroll is None else jnp.asarray(scroll))


def _pallas_base(grid, jplan, jcfg, jmed, scroll):
    gperm = jnp.transpose(jnp.asarray(grid), jplan.perm + (3,))
    return sp.sweep_base_pallas_ref(
        gperm, jplan, jcfg, jmed, None,
        scroll=None if scroll is None else jnp.asarray(scroll),
        interpret=True)


def _port_base(grid, tplan, tcfg, tmed, scroll):
    g = grid if isinstance(grid, torch.Tensor) else torch.from_numpy(grid)
    return sweep_ref_fwd.sweep_base_ref(g.permute(tplan.perm + (3,)), tplan,
                                        tcfg, tmed, LightConfig(), scroll)


def _assert_maps_close(got, want):
    for g, w, n in zip(got, want, NAMES):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _offsets_np(offs):
    return np.array([[float(o) for o in triple] for triple in offs])


@pytest.mark.parametrize("eye,axis", AXIS_EYES)
@pytest.mark.parametrize("kind", SCROLLS)
def test_channel_offsets_and_layer_channels(eye, axis, kind):
    """The scroll lands on the sweep, row or column axis depending on the
    plan's coord order; the L build matches the JAX precompute."""
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(True, eye)
    assert tplan.axis == axis
    scroll = _scroll(kind)
    joffs = sp._channel_offsets(
        jmed, None if scroll is None else jnp.asarray(scroll),
        jplan.coord_order)
    toffs = sweep_ref_fwd._channel_offsets(tmed, scroll, tplan.coord_order)
    np.testing.assert_array_equal(_offsets_np(toffs), _offsets_np(joffs))
    # the preset's scroll moves nothing; the seeded one moves every axis
    assert np.any(_offsets_np(toffs) != 0.0) == (kind == "random")
    gperm = torch.from_numpy(grid).permute(tplan.perm + (3,))
    got = sweep_ref_fwd._layer_channels(gperm, tplan.slice_z, tmed, toffs,
                                        "mirror")
    want = sp._layer_channels(
        jnp.transpose(jnp.asarray(grid), jplan.perm + (3,)), jplan.slice_z,
        jmed, joffs, "mirror")
    assert got.shape == (D, 4, D, D) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_params_layout():
    """The first sixteen params are the TPU kernels' own; the a offsets
    (inside the TPU's row matrices) follow."""
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(True, AXIS_EYES[0][0])
    scroll = _scroll("random")
    toffs = sweep_ref_fwd._channel_offsets(tmed, scroll, tplan.coord_order)
    params = sweep_ref_fwd._params_ref(tplan, tcfg, tmed, LightConfig(),
                                       toffs).numpy()
    assert params.shape == (build.N_PARAMS,)
    joffs = sp._channel_offsets(jmed, jnp.asarray(scroll), jplan.coord_order)
    from volumetricrenderer_tpu.config import LightConfig as JLight
    want = np.concatenate([
        np.asarray(sp._params_for(jplan, jcfg, jmed, JLight())),
        np.asarray(jmed.channel_coord_scale, np.float32),
        [float(joffs[c][2]) for c in range(4)],
        [float(joffs[c][1]) for c in range(4)]]).astype(np.float32)
    np.testing.assert_array_equal(params, want)


@pytest.mark.parametrize("emission", [False, True])
@pytest.mark.parametrize("kind", SCROLLS)
def test_forward_matches_jnp_and_pallas(emission, kind):
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(emission)
    scroll = _scroll(kind)
    got = _port_base(grid, tplan, tcfg, tmed, scroll)
    _assert_maps_close(got, _jnp_base(grid, jplan, jcfg, jmed, scroll))
    _assert_maps_close(got, _pallas_base(grid, jplan, jcfg, jmed, scroll))
    assert float(got[3].max()) == (0.0 if emission else 1.0)


@pytest.mark.parametrize("eye,axis", AXIS_EYES)
@pytest.mark.parametrize("emission", [False, True])
def test_forward_axes_with_nonzero_offsets(eye, axis, emission):
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(emission, eye)
    assert tplan.axis == axis
    scroll = _scroll("random")
    got = _port_base(grid, tplan, tcfg, tmed, scroll)
    _assert_maps_close(got, _jnp_base(grid, jplan, jcfg, jmed, scroll))
    _assert_maps_close(got, _pallas_base(grid, jplan, jcfg, jmed, scroll))
    # the scroll matters: the unscrolled maps differ
    still = _port_base(grid, tplan, tcfg, tmed, None)
    k = 2 if emission else 0
    assert float((got[k] - still[k]).abs().max()) > 1e-3


@pytest.mark.parametrize("emission", [False, True])
def test_forward_sub_voxel_slicing(emission):
    """n_slices != depth: the L build lerps onto the slice planes."""
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(
        emission, AXIS_EYES[0][0], n_slices=24)
    scroll = _scroll("random")
    _assert_maps_close(_port_base(grid, tplan, tcfg, tmed, scroll),
                       _jnp_base(grid, jplan, jcfg, jmed, scroll))


def _loss_j(base_fn, g, jplan, jcfg, jmed, scroll):
    acc, trans, wsum, hit = base_fn(g, jplan, jcfg, jmed, scroll)
    return (jnp.sum(wsum ** 2) + jnp.sum(trans ** 2)
            + jnp.sum(acc ** 2) * 0.1)


def _port_grad(grid, tplan, tcfg, tmed, scroll):
    g = torch.from_numpy(grid.copy()).requires_grad_()
    acc, trans, wsum, hit = _port_base(g, tplan, tcfg, tmed, scroll)
    ((wsum ** 2).sum() + (trans ** 2).sum() + (acc ** 2).sum() * 0.1) \
        .backward()
    return g.grad.numpy()


@pytest.mark.parametrize("eye,axis", AXIS_EYES)
@pytest.mark.parametrize("emission", [False, True])
def test_grid_gradient_matches_jnp_and_pallas(eye, axis, emission):
    """The port's grid gradient (the plain backward, then autograd through
    the L build) against jax.grad through the jnp sweep and through K4/K5
    in interpret mode, with nonzero offsets on every axis."""
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(emission, eye, seed=3)
    scroll = _scroll("random")
    got = _port_grad(grid, tplan, tcfg, tmed, scroll)
    with jax.default_matmul_precision("highest"):
        for base_fn in (_jnp_base, _pallas_base):
            want = np.asarray(jax.grad(
                lambda g: _loss_j(base_fn, g, jplan, jcfg, jmed, scroll))(
                    jnp.asarray(grid)))
            scale = np.abs(want).max()
            assert scale > 0
            np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * scale,
                                       err_msg=base_fn.__name__)
    for c in range(4):
        assert np.abs(got[..., c]).max() > 0


def _bwd_vs_autograd(emission, eye, kind, density=1.0, seed=0):
    grid, _, _, _, tcfg, tplan, tmed = _setup(emission, eye, seed=seed,
                                              density=density)
    inputs = sweep_ref_fwd.sweep_ref_inputs(
        torch.from_numpy(grid).permute(tplan.perm + (3,)), tplan, tcfg, tmed,
        None, _scroll(kind))
    L = inputs[0].clone().requires_grad_()
    maps = sweep_ref_fwd.sweep_ref_fwd_reference(L, *inputs[1:],
                                                 emission=emission)
    rng = np.random.default_rng(9)
    cts = [torch.from_numpy(rng.normal(size=tplan.base_shape)
                            .astype(np.float32)) for _ in range(3)]
    auto, = torch.autograd.grad(
        sum((m * c).sum() for m, c in zip(maps[:3], cts)), L)
    got = sweep_ref_bwd.sweep_ref_bwd_reference(
        L.detach(), *inputs[1:], *cts, maps[1].detach(), maps[2].detach(),
        emission=emission)
    return got, auto, maps


@pytest.mark.parametrize("eye,axis", AXIS_EYES)
@pytest.mark.parametrize("emission", [False, True])
@pytest.mark.parametrize("kind", ["none", "random"])
def test_plain_backward_matches_autograd(eye, axis, emission, kind):
    """The closed-form plain backward (what K5 is held to on the card)
    against autograd of the plain forward, on seeded normal cotangents:
    rtol=2e-4, atol=2e-4 * max|dL| (float32 sums in another order)."""
    got, auto, _ = _bwd_vs_autograd(emission, eye, kind)
    scale = float(auto.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, auto, rtol=2e-4, atol=2e-4 * scale)


def test_plain_backward_early_stop_gate():
    """density 500: rays go opaque within a few slices and the live gate
    cuts the rest; the replay must stop where the forward stopped
    (tolerance 5e-4, the JAX tests' for this case)."""
    got, auto, maps = _bwd_vs_autograd(True, (3.0, 0.4, 0.3), "random",
                                       density=500.0)
    assert float(maps[1].detach().min()) < 1e-3
    scale = float(auto.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, auto, rtol=5e-4, atol=5e-4 * scale)


def test_supported_gate_reference():
    cfg = RenderConfig(emission=False, quadrature="sliced")
    med = MediumConfig(combine="reference")
    scroll = reference_media_scroll(1.0)
    assert sweep_fwd.supported(cfg, med, None, scroll, 4)
    assert sweep_fwd.supported(cfg, med, None, None, 4)
    # clamp addressing: the scrolled coords leave [0, 1]
    assert not sweep_fwd.supported(
        dataclasses.replace(cfg, address_mode="clamp"), med, None, scroll, 4)
    # a single-channel grid with the reference combine is invalid
    assert not sweep_fwd.supported(cfg, med, None, None, 3)
    assert not sweep_fwd.supported(cfg, med, object(), None, 4)
    assert sweep_fwd.supported(
        dataclasses.replace(cfg, dtype="bfloat16"), med, None, None, 4)
    assert not sweep_fwd.supported(
        dataclasses.replace(cfg, dtype="float16"), med, None, None, 4)


def test_unported_reference_options_raise():
    """What the port still refuses: a light volume that is not 3-D, the
    float16 type and a 3-D grid with the reference combine (the
    configurations it once refused besides are held to JAX by
    test_repaired_reference_options_match_jax)."""
    grid, _, _, _, tcfg, tplan, tmed = _setup(True)
    g = torch.from_numpy(grid)
    with pytest.raises(NotImplementedError, match="light volume"):
        sweep_render(g, tplan, tcfg, tmed, light_volume=g)
    with pytest.raises(NotImplementedError, match="float16"):
        sweep_render(g, tplan, dataclasses.replace(tcfg, dtype="float16"),
                     tmed)
    with pytest.raises(NotImplementedError):
        sweep_render(g[..., 0], tplan, tcfg, tmed)


@pytest.mark.parametrize("case", ["absorption with a light volume",
                                  "light volume of another shape",
                                  "clamp addressing"])
def test_repaired_reference_options_match_jax(case):
    """The reference-medium configurations the port once refused, against
    the JAX jnp sweep's frame on the same plan: a light volume with
    absorption (never read), one of another shape than the grid's, and
    clamp addressing (both through the general sweep)."""
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(True)
    lvol = grid[..., 0].copy()
    if case.startswith("absorption"):
        jcfg = dataclasses.replace(jcfg, emission=False)
        tcfg = dataclasses.replace(tcfg, emission=False)
    elif case.startswith("light"):
        lvol = lvol[:-1].copy()
    else:
        jcfg = dataclasses.replace(jcfg, address_mode="clamp")
        tcfg = dataclasses.replace(tcfg, address_mode="clamp")
        lvol = None
    scroll = np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)
    want = np.asarray(jsweep_render(
        jnp.asarray(grid), jplan, jcfg, jmed, scroll=jnp.asarray(scroll),
        light_volume=None if lvol is None else jnp.asarray(lvol),
        use_pallas=False))
    got = sweep_render(torch.from_numpy(grid), tplan, tcfg, tmed,
                       scroll=torch.from_numpy(scroll),
                       light_volume=None if lvol is None
                       else torch.from_numpy(lvol))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(got[..., 3].max()) > 0.0


def test_reference_media_scroll_matches_jax():
    for t in (0.0, 1.7):
        np.testing.assert_array_equal(reference_media_scroll(t).numpy(),
                                      np.asarray(jscroll(t)))
    assert reference_media_scroll(2.0, n_channels=2).shape == (2, 3)


def test_kernel_launches_refuse_cpu_tensors():
    grid, _, _, _, tcfg, tplan, tmed = _setup(True)
    inputs = sweep_ref_fwd.sweep_ref_inputs(
        torch.from_numpy(grid).permute(tplan.perm + (3,)), tplan, tcfg, tmed)
    maps = torch.zeros((3,) + tplan.base_shape)
    before = (sweep_ref_fwd.launches, sweep_ref_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_ref_fwd.launch_kernel(*inputs, True)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_ref_bwd.launch_kernel(*inputs, *maps, maps[1], maps[2],
                                    emission=True)
    assert (sweep_ref_fwd.launches, sweep_ref_bwd.launches) == before


def test_cpu_frames_take_no_frame_graphs():
    """A CPU grid's 4-channel frame never looks for CUDA graphs
    (ops/sweep.py _ref_frame_entry), however often its key repeats: its
    frames equal, frame after frame, with the scroll read each time."""
    from volumetricrenderer_tpu_torch.ops import sweep as tsweep
    grid, _, _, _, tcfg, tplan, tmed = _setup(False)
    g = torch.from_numpy(grid)
    scrolls = [torch.tensor(np.random.default_rng(s).uniform(-1, 1, (4, 3)),
                            dtype=torch.float32) for s in (1, 2)]
    assert tsweep._ref_frame_entry(g, tplan, tcfg, tmed, None, scrolls[0],
                                   None) is None
    with torch.no_grad():
        frames = [tsweep.sweep_render(g, tplan, tcfg, tmed, scroll=sc)
                  for sc in scrolls * 2]
    assert torch.equal(frames[0], frames[2])
    assert torch.equal(frames[1], frames[3])
    assert not torch.equal(frames[0], frames[1])
