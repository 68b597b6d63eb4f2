"""The forward sweep kernel's plain PyTorch version (sweep_fwd_reference)
against the JAX package, three ways on the same grid and the same plan:

* the jnp sweep `_sweep_base`,
* K1, the sc-major Pallas kernel `_run_fwd_sc`, called directly in
  interpret mode,
* K3, the rb-major Pallas kernel, through `sweep_base_pallas(...,
  interpret=True)` on the sub-voxel stack (at these widths it picks K3:
  its column-matmul forms need 128-multiple grid columns).

Tolerance rtol=2e-4, atol=2e-5 is the one tests/test_sweep_pallas.py holds
the Pallas kernels to. The CUDA kernel itself is held against the plain
version by tests/test_torch_gpu.py (skipped without a card) and by
chip_smoke.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu.config import CameraConfig as JCameraConfig
from volumetricrenderer_tpu.config import LightConfig as JLight
from volumetricrenderer_tpu.config import MediumConfig as JMedium
from volumetricrenderer_tpu.config import RenderConfig as JRender
from volumetricrenderer_tpu.kernels import sweep_pallas as sp
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.sweep import _sweep_base, plan_sweep
from volumetricrenderer_tpu_torch.config import LightConfig, MediumConfig, \
    RenderConfig
from volumetricrenderer_tpu_torch.kernels import sweep_fwd
from volumetricrenderer_tpu_torch.ops.sweep import SweepPlan

torch.set_num_threads(1)

D = 16
RTOL, ATOL = 2e-4, 2e-5
NAMES = ("acc", "trans", "wsum", "hit")

EYES = [
    ((3.0, 0.4, 0.3), 0, -1),
    ((-3.0, 0.4, 0.3), 0, 1),
    ((0.3, 3.0, 0.4), 1, -1),
    ((0.4, 0.3, 3.0), 2, -1),
    ((0.4, 0.3, -3.0), 2, 1),
]


def torch_plan(jplan):
    """The JAX plan's arrays as a torch SweepPlan (compares the sweeps on
    one plan; the plans themselves are compared in test_torch_plan.py)."""
    def t(x):
        return torch.from_numpy(np.array(x))
    return SweepPlan(
        eye01=t(jplan.eye01), v_grid=t(jplan.v_grid), u_grid=t(jplan.u_grid),
        slice_z=t(jplan.slice_z), seglen=t(jplan.seglen),
        warp_rows01=t(jplan.warp_rows01), warp_cols01=t(jplan.warp_cols01),
        box_range=t(jplan.box_range), box_min=t(jplan.box_min),
        axis=jplan.axis, sign=jplan.sign, perm=tuple(jplan.perm),
        coord_order=tuple(jplan.coord_order),
        identity_warp=jplan.identity_warp)


def _setup(eye, emission, mode="mirror", n_slices=None, seed=0):
    grid = np.random.default_rng(seed).uniform(0.2, 1.0, (D, D, D)) \
        .astype(np.float32)
    jcfg = JRender(emission=emission, quadrature="sliced", address_mode=mode)
    jplan = plan_sweep(make_camera(JCameraConfig(eye=eye, width=96,
                                                 height=64)),
                       grid.shape, jcfg, n_slices=n_slices)
    tcfg = RenderConfig(emission=emission, quadrature="sliced",
                        address_mode=mode)
    return (grid, jcfg, jplan, JMedium(combine="single", density=8.0),
            tcfg, torch_plan(jplan), MediumConfig(combine="single",
                                                  density=8.0))


def _twin(grid, tcfg, tplan, tmed):
    return sweep_fwd.sweep_base(torch.from_numpy(grid).permute(tplan.perm),
                                tplan, tcfg, tmed, LightConfig())


def _jperm(grid, jplan):
    return jnp.transpose(jnp.asarray(grid), jplan.perm)


def _assert_maps_close(got, want):
    for g, w, n in zip(got, want, NAMES):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _sweep_base_maps(grid, jcfg, jplan, jmed):
    return _sweep_base(_jperm(grid, jplan), None, jplan.slice_z,
                       jplan.v_grid, jplan.u_grid, jplan.seglen, jplan, jcfg,
                       jmed, JLight(), None)


@functools.partial(jax.jit, static_argnames=("emission", "flip", "wrap"))
def _k1(gperm, slice_z, wa, u_grid, seglen, params, *, emission, flip, wrap):
    # jit: one interpret-mode compile per static combination, shared by
    # every eye with the same flip (all plans here share their shapes)
    return sp._run_fwd_sc(gperm, None, slice_z, wa, u_grid, seglen, params,
                          jnp.zeros((1, 1), jnp.int32), 0, 8, 128, emission,
                          False, interpret=True, wrap=wrap, flip=flip)


def _k1_maps(grid, jcfg, jplan, jmed):
    return _k1(_jperm(grid, jplan), jplan.slice_z,
               sp._row_matrices(jplan, D, jcfg.address_mode), jplan.u_grid,
               jplan.seglen, sp._params_for(jplan, jcfg, jmed, JLight()),
               emission=jcfg.emission, flip=jplan.sign < 0,
               wrap=jcfg.address_mode == "wrap")


def _k3_maps(grid, jcfg, jplan, jmed):
    return sp.sweep_base_pallas(_jperm(grid, jplan), jplan, jcfg, jmed,
                                JLight(), interpret=True)


@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("emission", [True, False])
def test_twin_matches_sweep_base(eye, axis, sign, emission):
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(eye, emission)
    assert (tplan.axis, tplan.sign) == (axis, sign)
    _assert_maps_close(_twin(grid, tcfg, tplan, tmed),
                       _sweep_base_maps(grid, jcfg, jplan, jmed))


# Every eye in emission (the flagship medium), absorption on one; the jnp
# sweep above covers the full cross product.
@pytest.mark.parametrize("eye,emission", [(e, True) for e, _, _ in EYES]
                         + [(EYES[3][0], False)])
def test_twin_matches_k1(eye, emission):
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(eye, emission)
    _assert_maps_close(_twin(grid, tcfg, tplan, tmed),
                       _k1_maps(grid, jcfg, jplan, jmed))


@pytest.mark.parametrize("mode", ["clamp", "wrap"])
@pytest.mark.parametrize("emission", [True, False])
def test_twin_matches_address_modes(mode, emission):
    """mirror is covered above; clamp, and wrap (which differs from the
    other two at the half-texel border), against the jnp sweep."""
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(
        EYES[2][0], emission, mode=mode, seed=2)
    _assert_maps_close(_twin(grid, tcfg, tplan, tmed),
                       _sweep_base_maps(grid, jcfg, jplan, jmed))


@pytest.mark.parametrize("emission", [True, False])
def test_twin_matches_sub_voxel_slicing(emission):
    """n_slices != depth: the wrapper lerps the stack onto the slice
    planes first and sweeps it unflipped, as sweep_base_pallas does before
    it runs K3."""
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(
        EYES[0][0], emission, n_slices=24, seed=3)
    got = _twin(grid, tcfg, tplan, tmed)
    _assert_maps_close(got, _sweep_base_maps(grid, jcfg, jplan, jmed))
    if emission:
        _assert_maps_close(got, _k3_maps(grid, jcfg, jplan, jmed))


@pytest.mark.parametrize("mode", ["mirror", "clamp", "wrap"])
def test_layer_lerp_stack_and_params(mode):
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(
        EYES[1][0], True, mode=mode, n_slices=24)
    gperm = torch.from_numpy(grid).permute(tplan.perm)
    np.testing.assert_allclose(
        sweep_fwd._layer_lerp_stack(gperm, tplan.slice_z, mode).numpy(),
        np.asarray(sp._layer_lerp_stack(_jperm(grid, jplan), jplan.slice_z,
                                        mode)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        sweep_fwd._params_for(tplan, tcfg, tmed, LightConfig()).numpy(),
        np.asarray(sp._params_for(jplan, jcfg, jmed, JLight())))


def test_supported_gate():
    cfg = RenderConfig(emission=True, quadrature="sliced")
    med = MediumConfig(combine="single", density=8.0)
    assert sweep_fwd.supported(cfg, med, None, None, 3)
    assert not sweep_fwd.supported(cfg, MediumConfig(), None, None, 3)
    assert not sweep_fwd.supported(
        dataclasses.replace(cfg, dtype="bfloat16"), med, None, None, 3)
    assert not sweep_fwd.supported(cfg, med, None, None, 4)
    assert not sweep_fwd.supported(cfg, med, None, object(), 3)
    assert not sweep_fwd.supported(cfg, med, object(), None, 3)


def test_kernel_launch_refuses_cpu_tensors():
    grid, jcfg, jplan, jmed, tcfg, tplan, tmed = _setup(EYES[0][0], True)
    inputs, flip = sweep_fwd.sweep_inputs(
        torch.from_numpy(grid).permute(tplan.perm), tplan, tcfg, tmed)
    before = sweep_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        sweep_fwd.launch_kernel(*inputs, True, flip, False)
    assert sweep_fwd.launches == before
