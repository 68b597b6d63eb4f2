"""The backward sweep: the port's grid gradient through kernels/sweep_fwd's
autograd node, which on the CPU runs the backward kernel's plain PyTorch
version (sweep_bwd_reference), against the JAX package on the same grid,
plan and cotangents:

* jax.grad of the jnp sweep `_sweep_base`,
* jax.grad of `sweep_base_pallas(..., interpret=True)`, whose backward is
  K2 (`_bwd_kernel`) run by the Pallas interpreter,
* and, inside the port, autograd of the forward's plain version.

The loss is the weighted-map loss of tests/test_sweep_pallas.py:
sum(acc * wa) + sum(trans * wt) + sum(wsum * wc) with seeded normal
weights. Tolerance rtol=2e-4, atol=2e-4 * max|dG|, and 5e-4 for the
early-stop case: the ones tests/test_sweep_pallas.py holds K2 to. The
CUDA kernel itself is held against sweep_bwd_reference by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sweep_fwd import EYES, torch_plan
from volumetricrenderer_tpu.config import CameraConfig as JCameraConfig
from volumetricrenderer_tpu.config import LightConfig as JLight
from volumetricrenderer_tpu.config import MediumConfig as JMedium
from volumetricrenderer_tpu.config import RenderConfig as JRender
from volumetricrenderer_tpu.kernels import sweep_pallas as sp
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.sweep import _sweep_base, plan_sweep
from volumetricrenderer_tpu_torch.config import LightConfig, MediumConfig, \
    RenderConfig
from volumetricrenderer_tpu_torch.kernels import build, sweep_bwd, sweep_fwd

torch.set_num_threads(1)

D = 16


def _setup(eye, emission, mode="mirror", n_slices=None, seed=3,
           density=8.0):
    grid = np.random.default_rng(seed).uniform(0.2, 1.0, (D, D, D)) \
        .astype(np.float32)
    jcfg = JRender(emission=emission, quadrature="sliced", address_mode=mode)
    jplan = plan_sweep(make_camera(JCameraConfig(eye=eye, width=96,
                                                 height=64)),
                       grid.shape, jcfg, n_slices=n_slices)
    Hb, Wb = jplan.base_shape
    rng = np.random.default_rng(9)
    wmaps = [rng.normal(size=(Hb, Wb)).astype(np.float32) for _ in range(3)]
    tcfg = RenderConfig(emission=emission, quadrature="sliced",
                        address_mode=mode)
    return dict(grid=grid, wmaps=wmaps, jcfg=jcfg, jplan=jplan,
                jmed=JMedium(combine="single", density=density), tcfg=tcfg,
                tplan=torch_plan(jplan),
                tmed=MediumConfig(combine="single", density=density))


def _loss(maps, wmaps):
    acc, trans, wsum, _ = maps
    wa, wt, wc = wmaps
    return (acc * wa).sum() + (trans * wt).sum() + (wsum * wc).sum()


def _port_grad(c):
    """dL/dgrid through the port's autograd node (CPU: the plain
    versions of both kernels)."""
    g = torch.from_numpy(c["grid"]).requires_grad_()
    maps = sweep_fwd.sweep_base(g.permute(c["tplan"].perm), c["tplan"],
                                c["tcfg"], c["tmed"], LightConfig())
    _loss(maps, [torch.from_numpy(w) for w in c["wmaps"]]).backward()
    return g.grad.numpy()


def _jnp_grad(c):
    jplan = c["jplan"]

    def loss(g):
        maps = _sweep_base(jnp.transpose(g, jplan.perm), None, jplan.slice_z,
                           jplan.v_grid, jplan.u_grid, jplan.seglen, jplan,
                           c["jcfg"], c["jmed"], JLight(), None)
        return _loss(maps, [jnp.asarray(w) for w in c["wmaps"]])
    return np.asarray(jax.grad(loss)(jnp.asarray(c["grid"])))


def _k2_grad(c):
    jplan = c["jplan"]

    def loss(g):
        maps = sp.sweep_base_pallas(jnp.transpose(g, jplan.perm), jplan,
                                    c["jcfg"], c["jmed"], JLight(),
                                    interpret=True)
        return _loss(maps, [jnp.asarray(w) for w in c["wmaps"]])
    return np.asarray(jax.grad(loss)(jnp.asarray(c["grid"])))


def _assert_grad_close(got, want, tol=2e-4):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("eye,axis,sign", EYES)
@pytest.mark.parametrize("emission", [True, False])
def test_grad_matches_sweep_base(eye, axis, sign, emission):
    c = _setup(eye, emission)
    assert (c["tplan"].axis, c["tplan"].sign) == (axis, sign)
    _assert_grad_close(_port_grad(c), _jnp_grad(c))


# K2 in interpret mode costs 4-10 s a case: both signs in emission (the
# mirrored dG write and the plain one), absorption once, and the gate case
# below.
@pytest.mark.parametrize("eye,emission", [(EYES[0][0], True),
                                          (EYES[4][0], True),
                                          (EYES[2][0], False)])
def test_grad_matches_k2(eye, emission):
    c = _setup(eye, emission)
    _assert_grad_close(_port_grad(c), _k2_grad(c))


@pytest.mark.parametrize("mode", ["clamp", "wrap"])
@pytest.mark.parametrize("emission", [True, False])
def test_grad_matches_address_modes(mode, emission):
    """Clamp puts both taps of an edge sample on one texel; wrap takes them
    modulo the layer size."""
    c = _setup(EYES[3][0], emission, mode=mode, seed=2)
    _assert_grad_close(_port_grad(c), _jnp_grad(c))


@pytest.mark.parametrize("emission", [True, False])
def test_grad_matches_sub_voxel_slicing(emission):
    """n_slices != depth: the backward writes dG for the lerped stack,
    and the lerp's own autograd carries it on to the grid."""
    c = _setup(EYES[0][0], emission, n_slices=24, seed=4)
    _assert_grad_close(_port_grad(c), _jnp_grad(c))


def test_grad_early_stop_gate():
    """Density 500 saturates rays mid-volume: the replay must stop where
    the forward's live gate stopped, so slices behind get no gradient."""
    c = _setup(EYES[0][0], True, seed=7, density=500.0)
    c["wmaps"][0][:] = 0.0
    got = _port_grad(c)
    _assert_grad_close(got, _jnp_grad(c), tol=5e-4)
    _assert_grad_close(got, _k2_grad(c), tol=5e-4)


@pytest.mark.parametrize("case", [
    dict(eye=EYES[0][0], emission=True),
    dict(eye=EYES[1][0], emission=False, mode="wrap"),
    dict(eye=EYES[2][0], emission=True, mode="clamp"),
    dict(eye=EYES[0][0], emission=True, n_slices=24),
    dict(eye=EYES[0][0], emission=True, density=500.0),
], ids=["mirror", "absorption-wrap", "clamp", "sub-voxel", "early-stop"])
def test_reference_matches_autograd_of_forward(case):
    """The closed-form replay equals autograd of the forward's plain
    version on the stack itself (flip and all)."""
    c = _setup(case["eye"], case["emission"], case.get("mode", "mirror"),
               case.get("n_slices"), density=case.get("density", 8.0))
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        torch.from_numpy(c["grid"]).permute(c["tplan"].perm), c["tplan"],
        c["tcfg"], c["tmed"])
    stack = stack.detach().requires_grad_()
    kw = dict(emission=c["tcfg"].emission, flip=flip,
              address_mode=c["tcfg"].address_mode)
    maps = sweep_fwd.sweep_fwd_reference(stack, *args, **kw)
    cts = [torch.from_numpy(w) for w in c["wmaps"]]
    want, = torch.autograd.grad(_loss(maps, cts), stack)
    got = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1].detach(),
                                        maps[2].detach(), **kw)
    _assert_grad_close(got.numpy(), want.numpy())


def test_hit_is_not_differentiable():
    c = _setup(EYES[0][0], False)
    g = torch.from_numpy(c["grid"]).requires_grad_()
    maps = sweep_fwd.sweep_base(g.permute(c["tplan"].perm), c["tplan"],
                                c["tcfg"], c["tmed"])
    assert maps[0].requires_grad and not maps[3].requires_grad


def test_cpu_backward_launches_no_kernel():
    c = _setup(EYES[3][0], True)
    before = (sweep_fwd.launches, sweep_bwd.launches)
    _port_grad(c)
    assert (sweep_fwd.launches, sweep_bwd.launches) == before


def test_kernel_launch_refuses_cpu_tensors():
    c = _setup(EYES[0][0], True)
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        torch.from_numpy(c["grid"]).permute(c["tplan"].perm), c["tplan"],
        c["tcfg"], c["tmed"])
    maps = torch.zeros((4,) + c["tplan"].base_shape)
    before = sweep_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        sweep_bwd.launch_kernel(stack, *args, maps[0], maps[1], maps[2],
                                maps[1], maps[2], True, flip, False)
    assert sweep_bwd.launches == before


def test_build_key_covers_included_headers(tmp_path):
    """An edited header must rebuild every source that includes it: the
    cached library's name hashes the source and its local includes."""
    src = os.path.join(build.CSRC, "sweep_bwd.cu")
    names = [os.path.basename(p) for p in build._source_files(src)]
    assert names == ["sweep_bwd.cu", "sweep_common.cuh", "sweep_tile.cuh"]

    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cu").write_text('#include "inc/a.cuh"\nint k;\n')
    (tmp_path / "inc" / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("int b = 1;\n")
    k0 = build.source_key(str(tmp_path / "k.cu"))
    assert build.source_key(str(tmp_path / "k.cu")) == k0
    (tmp_path / "inc" / "b.cuh").write_text("int b = 2;\n")
    k1 = build.source_key(str(tmp_path / "k.cu"))
    assert k1 != k0
    (tmp_path / "k.cu").write_text('#include "inc/a.cuh"\nint k2;\n')
    assert build.source_key(str(tmp_path / "k.cu")) not in (k0, k1)
