"""The light branch of the port's sweeps (the plain PyTorch versions of the
four CUDA kernels, through the autograd nodes of kernels/sweep_fwd.py and
kernels/sweep_ref_fwd.py) against the JAX package on the same grid, light
volume, plan and cotangents:

* the jnp sweep `_sweep_base` with a light volume,
* the Pallas kernels through `sweep_base_pallas(..., lperm=,
  interpret=True)`: K3/K2 for the single-channel medium, K4/K5 for the
  reference medium,
* and, inside the port, autograd of the plain forward (whose clip is
  ops/sampling.clip_unit, with jnp.clip's subgradient).

Two light volumes: the real one (ops/lighting.py of the JAX package), which
is exactly 1.0 in every fully lit voxel, so the clip's tie at 1 is common;
and that volume stretched to [-0.2, 1.3], which leaves [0, 1] on both
sides, so all three arms of the clip's subgradient are exercised.

Tolerances are the JAX tests' own (tests/test_sweep_pallas.py,
tests/test_sweep_pallas_ref.py): maps rtol=2e-4, atol=2e-5; gradients
rtol=2e-4, atol=2e-4 * max|grad|, 5e-4 in the early-stop case. The CUDA
kernels themselves are held against the plain versions by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sweep_fwd import torch_plan
from volumetricrenderer_tpu.config import CameraConfig as JCameraConfig
from volumetricrenderer_tpu.config import LightConfig as JLight
from volumetricrenderer_tpu.config import MediumConfig as JMedium
from volumetricrenderer_tpu.config import RenderConfig as JRender
from volumetricrenderer_tpu.kernels import sweep_pallas as sp
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.lighting import \
    light_transmittance_volume as jlight_volume
from volumetricrenderer_tpu.ops.sweep import _sweep_base, plan_sweep
from volumetricrenderer_tpu_torch.config import LightConfig, MediumConfig, \
    RenderConfig
from volumetricrenderer_tpu_torch.kernels import build, sweep_bwd, \
    sweep_fwd, sweep_ref_bwd, sweep_ref_fwd
from volumetricrenderer_tpu_torch.ops.resample import linear_resample_matrix

torch.set_num_threads(1)

D = 16
RTOL, ATOL = 2e-4, 2e-5
NAMES = ("acc", "trans", "wsum", "hit")
AMBIENT = 0.2
# The eyes of tests/test_sweep_pallas.py's test_forward_parity_light_volume:
# sweep axis x with sign -1 (the stack read mirrored) and z with sign +1.
LIGHT_EYES = [(3.0, 0.4, 0.3), (0.4, 0.3, -3.0)]


def _setup(eye, combine="single", mode="mirror", n_slices=None, seed=0,
           density=8.0, pushed=False):
    """One case: numpy grid, light volume and scroll, and both packages'
    configs on the JAX plan."""
    rng = np.random.default_rng(seed)
    shape = (D, D, D) if combine == "single" else (D, D, D, 4)
    grid = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    scroll = None
    if combine == "reference":
        scroll = np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
            .astype(np.float32)
    jcfg = JRender(emission=True, quadrature="sliced", address_mode=mode)
    jmed = JMedium(combine=combine, density=density)
    jlight = JLight(ambient=AMBIENT, shadow_steps=32)
    jplan = plan_sweep(make_camera(JCameraConfig(eye=eye, width=96,
                                                 height=64)),
                       grid.shape, jcfg, n_slices=n_slices)
    lvol = np.asarray(jlight_volume(
        jnp.asarray(grid), jlight, jcfg, jmed,
        scroll=None if scroll is None else jnp.asarray(scroll)))
    assert (lvol == 1.0).mean() > 0.02  # the lit face: exact ties
    if pushed:  # stretched to [-0.2, 1.3]
        lo = lvol.min()
        lvol = (1.5 * (lvol - lo) / (1.0 - lo) - 0.2).astype(np.float32)
        assert lvol.max() > 1.0 and lvol.min() < 0.0
    Hb, Wb = jplan.base_shape
    wrng = np.random.default_rng(11)
    wmaps = [np.zeros((Hb, Wb), np.float32),
             wrng.normal(size=(Hb, Wb)).astype(np.float32),
             wrng.normal(size=(Hb, Wb)).astype(np.float32)]
    return dict(
        grid=grid, lvol=np.array(lvol), scroll=scroll, wmaps=wmaps, jcfg=jcfg,
        jmed=jmed, jlight=jlight, jplan=jplan, tplan=torch_plan(jplan),
        tcfg=RenderConfig(emission=True, quadrature="sliced",
                          address_mode=mode),
        tmed=MediumConfig(combine=combine, density=density),
        tlight=LightConfig(ambient=AMBIENT, shadow_steps=32))


def _gperm(c, g):
    perm = c["jplan"].perm
    return jnp.transpose(g, perm + (3,) if g.ndim == 4 else perm)


def _jscroll(c):
    return None if c["scroll"] is None else jnp.asarray(c["scroll"])


def _jnp_base(c, g, lv):
    p = c["jplan"]
    return _sweep_base(_gperm(c, g), jnp.transpose(lv, p.perm), p.slice_z,
                       p.v_grid, p.u_grid, p.seglen, p, c["jcfg"], c["jmed"],
                       c["jlight"], _jscroll(c))


def _pallas_base(c, g, lv):
    p = c["jplan"]
    return sp.sweep_base_pallas(_gperm(c, g), p, c["jcfg"], c["jmed"],
                                c["jlight"],
                                lperm=jnp.transpose(lv, p.perm),
                                scroll=_jscroll(c), interpret=True)


def _port_base(c, g, lv):
    p = c["tplan"]
    if g.dim() == 4:
        return sweep_ref_fwd.sweep_base_ref(
            g.permute(p.perm + (3,)), p, c["tcfg"], c["tmed"], c["tlight"],
            c["scroll"], lperm=lv.permute(p.perm))
    return sweep_fwd.sweep_base(g.permute(p.perm), p, c["tcfg"], c["tmed"],
                                c["tlight"], lperm=lv.permute(p.perm))


def _loss(maps, wmaps):
    acc, trans, wsum, _ = maps
    wa, wt, wc = wmaps
    return (acc * wa).sum() + (trans * wt).sum() + (wsum * wc).sum()


def _port_maps(c):
    return _port_base(c, torch.from_numpy(c["grid"]),
                      torch.from_numpy(c["lvol"]))


def _port_grads(c):
    g = torch.from_numpy(c["grid"].copy()).requires_grad_()
    lv = torch.from_numpy(c["lvol"].copy()).requires_grad_()
    _loss(_port_base(c, g, lv),
          [torch.from_numpy(w) for w in c["wmaps"]]).backward()
    return g.grad.numpy(), lv.grad.numpy()


def _jax_grads(c, base_fn):
    wmaps = [jnp.asarray(w) for w in c["wmaps"]]
    return tuple(np.asarray(x) for x in jax.grad(
        lambda g, lv: _loss(base_fn(c, g, lv), wmaps), argnums=(0, 1))(
            jnp.asarray(c["grid"]), jnp.asarray(c["lvol"])))


def _assert_maps_close(got, want):
    for g, w, n in zip(got, want, NAMES):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _assert_grads_close(got, want, tol=2e-4):
    for g, w, name in zip(got, want, ("dgrid", "dlight")):
        scale = float(np.abs(w).max())
        assert scale > 0.0, name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("eye", LIGHT_EYES)
def test_forward_matches_jnp_and_pallas(eye):
    c = _setup(eye)
    got = _port_maps(c)
    g, lv = jnp.asarray(c["grid"]), jnp.asarray(c["lvol"])
    _assert_maps_close(got, _jnp_base(c, g, lv))
    _assert_maps_close(got, _pallas_base(c, g, lv))
    # the shade darkens: wsum falls below the unshaded 1 - T somewhere,
    # and the transmittance does not see the light
    unlit = sweep_fwd.sweep_base(
        torch.from_numpy(c["grid"]).permute(c["tplan"].perm), c["tplan"],
        c["tcfg"], c["tmed"], c["tlight"])
    torch.testing.assert_close(got[1], unlit[1], rtol=0, atol=0)
    assert float((unlit[2] - got[2]).max()) > 1e-3
    assert float((got[2] - unlit[2]).max()) <= 1e-6


@pytest.mark.parametrize("case", [
    dict(eye=LIGHT_EYES[0], mode="wrap"),
    dict(eye=LIGHT_EYES[0], mode="clamp", pushed=True),
    dict(eye=LIGHT_EYES[0], n_slices=24),
    dict(eye=(0.3, 3.0, 0.4), pushed=True),
], ids=["wrap", "clamp-pushed", "sub-voxel", "y-pushed"])
def test_forward_matches_jnp_modes(case):
    """Wrap and clamp taps, the light stack lerped with the grid onto 24
    slice planes, the y axis, and a light volume leaving [0, 1]."""
    c = _setup(**case)
    _assert_maps_close(_port_maps(c), _jnp_base(
        c, jnp.asarray(c["grid"]), jnp.asarray(c["lvol"])))


@pytest.mark.parametrize("eye", LIGHT_EYES)
@pytest.mark.parametrize("pushed", [False, True], ids=["ones", "pushed"])
def test_grads_match_jnp(eye, pushed):
    """dG and dL against jax.grad(..., argnums=(0, 1)) of the jnp sweep,
    with the light volume as an independent input."""
    c = _setup(eye, seed=5, pushed=pushed)
    _assert_grads_close(_port_grads(c), _jax_grads(c, _jnp_base))


@pytest.mark.parametrize("pushed", [False, True], ids=["ones", "pushed"])
def test_grads_match_k2(pushed):
    """dG and dL against K2 in interpret mode (its second output dl_ref),
    the setup of test_backward_parity_light_volume."""
    c = _setup(LIGHT_EYES[0], seed=5, pushed=pushed)
    _assert_grads_close(_port_grads(c), _jax_grads(c, _pallas_base))


@pytest.mark.parametrize("case", [
    dict(eye=LIGHT_EYES[1], mode="wrap"),
    dict(eye=LIGHT_EYES[0], n_slices=24, pushed=True),
], ids=["wrap", "sub-voxel-pushed"])
def test_grads_match_jnp_modes(case):
    c = _setup(seed=4, **case)
    _assert_grads_close(_port_grads(c), _jax_grads(c, _jnp_base))


def test_grads_early_stop_gate():
    """Density 500 with a light volume: Wr holds the shade, and the replay
    must still stop where the forward's live gate stopped."""
    c = _setup(LIGHT_EYES[0], seed=7, density=500.0)
    assert float(_port_maps(c)[1].min()) < 1e-3
    _assert_grads_close(_port_grads(c), _jax_grads(c, _jnp_base), tol=5e-4)


def _plain_bwd_vs_autograd(c):
    """(dG, dL) of the plain backward and of autograd of the plain
    forward, on the kernel's own inputs."""
    p, cts = c["tplan"], [torch.from_numpy(w) for w in c["wmaps"]]
    g, lv = torch.from_numpy(c["grid"]), torch.from_numpy(c["lvol"])
    if c["tmed"].combine == "reference":
        L, *args = sweep_ref_fwd.sweep_ref_inputs(
            g.permute(p.perm + (3,)), p, c["tcfg"], c["tmed"], c["tlight"],
            c["scroll"])
        light = sweep_ref_fwd.sweep_ref_light_slabs(lv.permute(p.perm), p,
                                                    c["tcfg"])
        kw = dict(emission=True)
        fwd = sweep_ref_fwd.sweep_ref_fwd_reference
        bwd = sweep_ref_bwd.sweep_ref_bwd_reference
    else:
        (L, *args), flip = sweep_fwd.sweep_inputs(
            g.permute(p.perm), p, c["tcfg"], c["tmed"], c["tlight"])
        light = sweep_fwd.sweep_light_stack(lv.permute(p.perm), p,
                                            c["tcfg"])
        kw = dict(emission=True, flip=flip,
                  address_mode=c["tcfg"].address_mode)
        fwd, bwd = sweep_fwd.sweep_fwd_reference, \
            sweep_bwd.sweep_bwd_reference
    L = L.detach().clone().requires_grad_()
    light = light.detach().clone().requires_grad_()
    maps = fwd(L, *args, light=light, **kw)
    auto = torch.autograd.grad(_loss(maps, cts), (L, light))
    got = bwd(L.detach(), *args, *cts, maps[1].detach(), maps[2].detach(),
              light=light.detach(), **kw)
    return got, auto


@pytest.mark.parametrize("case", [
    dict(eye=LIGHT_EYES[0]),
    dict(eye=LIGHT_EYES[1], pushed=True),
    dict(eye=LIGHT_EYES[0], mode="wrap", pushed=True),
    dict(eye=LIGHT_EYES[0], n_slices=24),
    dict(eye=LIGHT_EYES[0], density=500.0),
    dict(eye=LIGHT_EYES[0], combine="reference"),
    dict(eye=(2.0, -3.2, 2.4), combine="reference", pushed=True),
], ids=["ones", "pushed", "wrap-pushed", "sub-voxel", "early-stop",
        "reference-ones", "reference-pushed"])
def test_plain_backward_matches_autograd(case):
    """The closed-form plain backwards with their hand-written clip'
    (what K2 and K5 are held to on the card) against autograd of the plain
    forwards, whose clip is clip_unit."""
    c = _setup(seed=3, **case)
    got, auto = _plain_bwd_vs_autograd(c)
    tol = 5e-4 if case.get("density", 8.0) > 100.0 else 2e-4
    _assert_grads_close([x.numpy() for x in got],
                        [x.numpy() for x in auto], tol=tol)


def test_reference_forward_matches_jnp_and_pallas():
    """K4's light branch: the setup of
    test_reference_combine_light_volume_parity with a seeded scroll whose
    offsets are nonzero; the light volume comes from materialize_sigma."""
    c = _setup(LIGHT_EYES[0], combine="reference")
    got = _port_maps(c)
    g, lv = jnp.asarray(c["grid"]), jnp.asarray(c["lvol"])
    _assert_maps_close(got, _jnp_base(c, g, lv))
    _assert_maps_close(got, _pallas_base(c, g, lv))


@pytest.mark.parametrize("eye,n_slices,pushed", [
    ((2.0, -3.2, 2.4), None, True), ((1.5, 2.0, 3.4), 24, False)],
    ids=["y-pushed", "z-sub-voxel"])
def test_reference_forward_matches_jnp_axes(eye, n_slices, pushed):
    c = _setup(eye, combine="reference", n_slices=n_slices, pushed=pushed)
    _assert_maps_close(_port_maps(c), _jnp_base(
        c, jnp.asarray(c["grid"]), jnp.asarray(c["lvol"])))


@pytest.mark.parametrize("pushed", [False, True], ids=["ones", "pushed"])
def test_reference_grads_match_jnp(pushed):
    c = _setup(LIGHT_EYES[0], combine="reference", seed=3, pushed=pushed)
    got = _port_grads(c)
    _assert_grads_close(got, _jax_grads(c, _jnp_base))
    for ch in range(4):
        assert np.abs(got[0][..., ch]).max() > 0


def test_reference_grads_match_k5():
    """dG (through the slab build) and dL against K4/K5 in interpret
    mode."""
    c = _setup(LIGHT_EYES[0], combine="reference", seed=3)
    _assert_grads_close(_port_grads(c), _jax_grads(c, _pallas_base))


def test_supported_gate():
    """tests/test_sweep_pallas.py's gate for the light volume: emission
    with a 3-D light volume is accepted, absorption with one refused."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    med = MediumConfig(combine="single")
    lvol = torch.ones((D, D, D))
    assert sweep_fwd.supported(cfg, med, lvol, None, 3)
    assert sweep_fwd.supported(cfg, MediumConfig(combine="reference"), lvol,
                               torch.zeros((4, 3)), 4)
    assert sweep_fwd.supported(dataclasses.replace(cfg, address_mode="wrap"),
                               med, lvol, None, 3)
    assert not sweep_fwd.supported(cfg, med, lvol[..., None], None, 3)
    assert not sweep_fwd.supported(dataclasses.replace(cfg, emission=False),
                                   med, lvol, None, 3)
    assert not sweep_fwd.supported(
        dataclasses.replace(cfg, emission=False),
        MediumConfig(combine="reference"), lvol, None, 4)
    assert sweep_fwd.supported(dataclasses.replace(cfg, dtype="bfloat16"),
                               med, lvol, None, 3)
    assert not sweep_fwd.supported(dataclasses.replace(cfg, dtype="float16"),
                                   med, lvol, None, 3)


def test_light_needs_emission_and_the_grids_shape():
    c = _setup(LIGHT_EYES[0])
    p = c["tplan"]
    g, lv = torch.from_numpy(c["grid"]), torch.from_numpy(c["lvol"])
    with pytest.raises(ValueError, match="shape"):
        sweep_fwd.sweep_base(g.permute(p.perm), p, c["tcfg"], c["tmed"],
                             c["tlight"], lperm=lv[:-1].permute(p.perm))
    acfg = dataclasses.replace(c["tcfg"], emission=False)
    with pytest.raises(ValueError, match="emission"):
        sweep_fwd.sweep_base(g.permute(p.perm), p, acfg, c["tmed"],
                             c["tlight"], lperm=lv.permute(p.perm))
    g4 = g[..., None].expand(-1, -1, -1, 4)
    rmed = MediumConfig(combine="reference")
    with pytest.raises(ValueError, match="shape"):
        sweep_ref_fwd.sweep_base_ref(g4.permute(p.perm + (3,)), p, c["tcfg"],
                                     rmed, lperm=lv[:, :-1].permute(p.perm))
    with pytest.raises(ValueError, match="emission"):
        sweep_ref_fwd.sweep_base_ref(g4.permute(p.perm + (3,)), p, acfg,
                                     rmed, lperm=lv.permute(p.perm))


def test_layer_lerp_stack_uses_index_select():
    """The layer fetch of the sub-voxel lerp backpropagates through
    index_add_, not through the sort-based index_put_ of advanced
    indexing."""
    c = _setup(LIGHT_EYES[0], n_slices=24)
    g = torch.from_numpy(c["grid"].copy()).requires_grad_()
    out = sweep_fwd._layer_lerp_stack(g, c["tplan"].slice_z, "mirror")
    assert out.shape == (24, D, D)
    names = set()
    todo = [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in names:
            continue
        names.add(fn)
        todo += [f for f, _ in fn.next_functions]
    kinds = {type(fn).__name__ for fn in names}
    assert "IndexSelectBackward0" in kinds
    assert not any(k.startswith("IndexBackward") for k in kinds)


def test_cpu_light_sweep_launches_no_kernel():
    c = _setup(LIGHT_EYES[0])
    mods = (sweep_fwd, sweep_bwd, sweep_ref_fwd, sweep_ref_bwd)
    before = [m.launches for m in mods]
    _port_grads(c)
    assert [m.launches for m in mods] == before


@pytest.mark.parametrize("mode", ["mirror", "clamp", "wrap"])
def test_light_sample_taps(mode):
    """The plain versions' light sample: the banded-matmul bilinear sample
    to float32 rounding, and exactly 1.0 on an all-ones layer whatever the
    fractions ((1 - f) + f rounds to 1 in float32), so a fully lit region
    ties with the clip's bound in every evaluation order."""
    rng = np.random.default_rng(0)
    layer = torch.from_numpy(rng.uniform(0.0, 1.0, (9, 13))
                             .astype(np.float32))
    a01 = torch.from_numpy(rng.uniform(0.0, 1.0, 40).astype(np.float32))
    b01 = torch.from_numpy(rng.uniform(0.0, 1.0, 50).astype(np.float32))
    got = build.light_sample(layer, a01, b01, mode)
    want = (linear_resample_matrix(a01, 9, mode) @ layer
            @ linear_resample_matrix(b01, 13, mode).T)
    assert got.shape == (40, 50)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    ones = build.light_sample(torch.ones_like(layer), a01, b01, mode)
    assert bool((ones == 1.0).all())
