"""The bfloat16 stream mode of the port's sweeps (the plain PyTorch versions
of the four CUDA kernels, through the autograd nodes) against the JAX
package in the same mode, on the same grid, plan and cotangents: the port's
counterparts of tests/test_bf16.py, plus what the port adds to the mode.

The mode's definition is in kernels/sweep_fwd.py: texels and tap weights
rounded to bfloat16, everything else float32. The JAX package rounds in
other places too (the staged product between its two matmuls, K5's dL), so
the two agree to bfloat16 precision, not to float32 rounding:

* maps: rtol = atol = 2e-2, the tolerance tests/test_bf16.py holds the
  Pallas kernels to the jnp sweep with;
* gradients against jax.grad through the interpret-mode kernels and the jnp
  sweep: rtol = 3e-2, atol = 3e-2 * max|grad|, on cases where no ray
  reaches the early-stop gate and with light volumes strictly inside
  (0, 1), where no clip tie decides a sample;
* inside the port (plain backward against autograd of the plain forward,
  both in the mode) the float32 tests' own 2e-4.

The CUDA kernels' bfloat16 instantiations are held against these plain
versions by tests/test_torch_gpu.py (skipped without a card) and by
chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from test_torch_sweep_fwd import torch_plan
from volumetricrenderer_tpu.kernels import sweep_pallas as sp
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu_torch.kernels import build, sweep_bwd, \
    sweep_fwd, sweep_ref_bwd, sweep_ref_fwd
from volumetricrenderer_tpu_torch.ops.resample import linear_resample_matrix, \
    linear_taps

torch.set_num_threads(1)

D = 16
TOL = 2e-2        # maps, as tests/test_bf16.py
GRAD_TOL = 3e-2   # gradients against JAX's differently rounded bfloat16
NAMES = ("acc", "trans", "wsum", "hit")
EYES = [(3.0, 0.4, 0.3), (0.3, 3.0, 0.4), (0.4, 0.3, -3.0)]  # x-, y-, z+


def _setup(eye, combine="single", emission=True, lit=False, mode="mirror",
           n_slices=None, seed=0, density=None):
    """One case in both packages on the JAX plan: numpy grid, optional
    light volume strictly inside (0, 1), a seeded scroll for the reference
    medium, seeded cotangents."""
    rng = np.random.default_rng(seed)
    ref = combine == "reference"
    grid = rng.uniform(0.2, 1.0, (D, D, D, 4) if ref else (D, D, D)) \
        .astype(np.float32)
    lvol = rng.uniform(0.05, 0.95, (D, D, D)).astype(np.float32) \
        if lit else None
    scroll = np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32) if ref else None
    if density is None:
        density = 2.0 if ref else 8.0
    kw = dict(emission=emission, quadrature="sliced", address_mode=mode,
              dtype="bfloat16")
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    jplan = jsweep.plan_sweep(
        J.make_camera(J.CameraConfig(eye=eye, width=96, height=64)),
        grid.shape, jcfg, n_slices=n_slices)
    wrng = np.random.default_rng(11)
    wmaps = [wrng.normal(size=jplan.base_shape).astype(np.float32)
             for _ in range(3)]
    if emission:
        wmaps[0][:] = 0.0
    else:
        wmaps[1][:] = 0.0
        wmaps[2][:] = 0.0
    return dict(
        grid=grid, lvol=lvol, scroll=scroll, wmaps=wmaps, jcfg=jcfg,
        tcfg=tcfg, jplan=jplan, tplan=torch_plan(jplan),
        jmed=J.MediumConfig(combine=combine, density=density),
        tmed=T.MediumConfig(combine=combine, density=density),
        jlight=J.LightConfig(ambient=0.2, shadow_steps=32 if lit else 0),
        tlight=T.LightConfig(ambient=0.2, shadow_steps=32 if lit else 0))


def _jperm(c, g):
    perm = c["jplan"].perm
    return jnp.transpose(g, perm + (3,) if g.ndim == 4 else perm)


def _jopt(x):
    return None if x is None else jnp.asarray(x)


def _jnp_base(c, g, lv):
    p = c["jplan"]
    return jsweep._sweep_base(
        _jperm(c, g), None if lv is None else jnp.transpose(lv, p.perm),
        p.slice_z, p.v_grid, p.u_grid, p.seglen, p, c["jcfg"], c["jmed"],
        c["jlight"], _jopt(c["scroll"]))


def _pallas_base(c, g, lv):
    p = c["jplan"]
    return sp.sweep_base_pallas(
        _jperm(c, g), p, c["jcfg"], c["jmed"], c["jlight"],
        lperm=None if lv is None else jnp.transpose(lv, p.perm),
        scroll=_jopt(c["scroll"]), interpret=True)


def _port_base(c, g, lv, cfg=None):
    p, cfg = c["tplan"], cfg or c["tcfg"]
    lperm = None if lv is None else lv.permute(p.perm)
    if g.dim() == 4:
        return sweep_ref_fwd.sweep_base_ref(
            g.permute(p.perm + (3,)), p, cfg, c["tmed"], c["tlight"],
            c["scroll"], lperm=lperm)
    return sweep_fwd.sweep_base(g.permute(p.perm), p, cfg, c["tmed"],
                                c["tlight"], lperm=lperm)


def _topt(x):
    return None if x is None else torch.from_numpy(x.copy())


def _port_maps(c, cfg=None):
    return _port_base(c, _topt(c["grid"]), _topt(c["lvol"]), cfg)


def _loss(maps, wmaps):
    return sum((m * w).sum() for m, w in zip(maps[:3], wmaps))


def _port_grads(c):
    g = _topt(c["grid"]).requires_grad_()
    lv = _topt(c["lvol"])
    if lv is not None:
        lv.requires_grad_()
    _loss(_port_base(c, g, lv), [torch.from_numpy(w) for w in c["wmaps"]]) \
        .backward()
    return [g.grad.numpy()] + ([] if lv is None else [lv.grad.numpy()])


def _jax_grads(c, base_fn):
    wmaps = [jnp.asarray(w) for w in c["wmaps"]]
    if c["lvol"] is None:
        return [np.asarray(jax.grad(
            lambda g: _loss(base_fn(c, g, None), wmaps))(
                jnp.asarray(c["grid"])), dtype=np.float32)]
    return [np.asarray(x, dtype=np.float32) for x in jax.grad(
        lambda g, lv: _loss(base_fn(c, g, lv), wmaps), argnums=(0, 1))(
            jnp.asarray(c["grid"]), jnp.asarray(c["lvol"]))]


def _assert_maps_close(got, want, tol=TOL):
    for g, w, n in zip(got, want, NAMES):
        assert g.dtype == torch.float32, n
        np.testing.assert_allclose(
            g.detach().numpy(), np.asarray(w, dtype=np.float32), rtol=tol,
            atol=tol, err_msg=n)


def _assert_grads_close(got, want, tol=GRAD_TOL):
    assert len(got) == len(want)
    for g, w, name in zip(got, want, ("dgrid", "dlight")):
        scale = float(np.abs(w).max())
        assert scale > 0.0, name
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=name)


# --- the counterparts of tests/test_bf16.py -------------------------------

def _render(dtype, package):
    P, cloud = package, np.asarray(J.cloud_volume(16, seed=7))
    cfg = P.RenderConfig(emission=True, quadrature="sliced", dtype=dtype)
    med = P.MediumConfig(combine="single", density=8.0)
    cam = P.make_camera(P.CameraConfig(width=48, height=32))
    if P is J:
        plan = jsweep.plan_sweep(cam, cloud.shape, cfg)
        return np.asarray(jsweep.sweep_render(jnp.asarray(cloud), plan, cfg,
                                              med, use_pallas=False))
    return T.render_image(torch.from_numpy(cloud.copy()), cam, cfg,
                          med).numpy()


def test_bf16_sweep_close_to_f32():
    """The bfloat16 image within 3e-2 max / 3e-3 mean of the float32 one
    (tests/test_bf16.py's bounds), and within 2e-2 of the JAX package's
    bfloat16 image."""
    a, b = _render("float32", T), _render("bfloat16", T)
    assert np.isfinite(b).all() and b.dtype == np.float32
    assert np.abs(a - b).max() < 3e-2, np.abs(a - b).max()
    assert np.abs(a - b).mean() < 3e-3
    assert np.abs(a - b).max() > 0.0  # the mode did something
    np.testing.assert_allclose(b, _render("bfloat16", J), rtol=TOL, atol=TOL)


def test_bf16_config_dtype():
    assert T.RenderConfig(dtype="bfloat16").torch_dtype == torch.bfloat16
    assert T.RenderConfig().torch_dtype == torch.float32
    assert J.RenderConfig(dtype="bfloat16").jnp_dtype == jnp.bfloat16


def test_bf16_in_kernel_gate():
    """Both kernel families take the bfloat16 stream, as
    sweep_pallas.supported does; no other type is taken."""
    c = _setup(EYES[0])
    assert sp.supported(c["jplan"], c["jcfg"], c["jmed"], None, None, 3, D)
    assert sweep_fwd.supported(c["tcfg"], c["tmed"], None, None, 3)
    assert sweep_fwd.supported(c["tcfg"], T.MediumConfig(), None,
                               torch.zeros((4, 3)), 4)
    lvol = torch.ones((D, D, D))
    assert sweep_fwd.supported(c["tcfg"], c["tmed"], lvol, None, 3)
    assert sweep_fwd.supported(c["tcfg"], T.MediumConfig(), lvol, None, 4)
    assert not sweep_fwd.supported(
        dataclasses.replace(c["tcfg"], dtype="float16"), c["tmed"], None,
        None, 3)


@pytest.mark.parametrize("eye", EYES)
@pytest.mark.parametrize("lit", [False, True], ids=["nolight", "light"])
def test_bf16_parity_vs_jnp_and_pallas(eye, lit):
    """The plain single-channel sweep in the mode against the jnp sweep and
    the Pallas kernels (interpret mode), both at bfloat16."""
    c = _setup(eye, lit=lit)
    got = _port_maps(c)
    g, lv = jnp.asarray(c["grid"]), _jopt(c["lvol"])
    _assert_maps_close(got, _jnp_base(c, g, lv))
    _assert_maps_close(got, _pallas_base(c, g, lv))


@pytest.mark.parametrize("case", [
    dict(eye=EYES[0], emission=False),
    dict(eye=EYES[1], mode="clamp"),
    dict(eye=EYES[2], mode="wrap", lit=True),
    dict(eye=EYES[0], n_slices=24),
    dict(eye=EYES[0], n_slices=24, lit=True),
], ids=["absorption", "clamp", "wrap-light", "sub-voxel", "sub-voxel-light"])
def test_bf16_parity_modes(case):
    """Absorption, clamp and wrap taps, and sub-voxel slicing, where the
    stack is lerped in float32 first and then rounded (sweep_pallas.py
    :1555, :1603), against the jnp sweep; the sub-voxel stacks against K3
    too."""
    c = _setup(**case)
    got = _port_maps(c)
    g, lv = jnp.asarray(c["grid"]), _jopt(c["lvol"])
    _assert_maps_close(got, _jnp_base(c, g, lv))
    if case.get("n_slices"):
        _assert_maps_close(got, _pallas_base(c, g, lv))


def test_bf16_parity_vs_k1():
    """K1, the sc-major kernel, called directly in interpret mode with the
    grid and the row matrices in bfloat16, as its wrapper casts them."""
    c = _setup(EYES[0])
    p = c["jplan"]
    want = sp._run_fwd_sc(
        _jperm(c, jnp.asarray(c["grid"])).astype(jnp.bfloat16), None,
        p.slice_z, sp._row_matrices(p, D, "mirror").astype(jnp.bfloat16),
        p.u_grid, p.seglen,
        sp._params_for(p, c["jcfg"], c["jmed"], c["jlight"]),
        jnp.zeros((1, 1), jnp.int32), 0, 8, 128, True, False, interpret=True,
        wrap=False, flip=p.sign < 0)
    _assert_maps_close(_port_maps(c), want)


@pytest.mark.parametrize("eye,lit,emission", [
    (EYES[0], False, True), (EYES[2], True, True), (EYES[1], False, False)],
    ids=["x", "z-light", "y-absorption"])
def test_bf16_reference_kernels_parity(eye, lit, emission):
    """The plain 4-channel sweep in the mode against the jnp sweep and K4
    (interpret mode), both at bfloat16, with a seeded scroll."""
    c = _setup(eye, combine="reference", lit=lit, emission=emission)
    assert sp.supported(c["jplan"], c["jcfg"], c["jmed"], None, None, 4, D)
    got = _port_maps(c)
    g, lv = jnp.asarray(c["grid"]), _jopt(c["lvol"])
    _assert_maps_close(got, _jnp_base(c, g, lv))
    _assert_maps_close(got, _pallas_base(c, g, lv))


@pytest.mark.parametrize("eye,lit", [(EYES[0], False), (EYES[2], True)],
                         ids=["nolight", "light"])
def test_bf16_grads_match_jax(eye, lit):
    """dG (and dL of a light volume inside (0, 1)) against jax.grad through
    K3/K2 in interpret mode and through the jnp sweep. No ray reaches the
    early-stop gate."""
    c = _setup(eye, lit=lit, seed=5)
    assert float(_port_maps(c)[1].min()) > 1e-2
    got = _port_grads(c)
    _assert_grads_close(got, _jax_grads(c, _pallas_base))
    _assert_grads_close(got, _jax_grads(c, _jnp_base))


@pytest.mark.parametrize("lit", [False, True], ids=["nolight", "light"])
def test_bf16_reference_grads_match_jax(lit):
    """The grid gradient through the slab build and the 4-channel sweep
    (and dL) against jax.grad through K4/K5 in interpret mode, which rounds
    its dL to bfloat16, and through the jnp sweep."""
    c = _setup(EYES[0], combine="reference", lit=lit, seed=3)
    assert float(_port_maps(c)[1].min()) > 1e-2
    got = _port_grads(c)
    _assert_grads_close(got, _jax_grads(c, _pallas_base))
    _assert_grads_close(got, _jax_grads(c, _jnp_base))
    for ch in range(4):
        assert np.abs(got[0][..., ch]).max() > 0


# --- what the port adds to the mode ---------------------------------------

def _kernel_inputs(c, low=True):
    """The plain versions' own inputs, in the mode unless low is False:
    (stack, args, light or None, forward keywords, forward, backward)."""
    p = c["tplan"]
    g, lv = _topt(c["grid"]), _topt(c["lvol"])
    if c["tmed"].combine == "reference":
        stack, *args = sweep_ref_fwd.sweep_ref_inputs(
            g.permute(p.perm + (3,)), p, c["tcfg"], c["tmed"], c["tlight"],
            c["scroll"])
        light = None if lv is None else sweep_ref_fwd.sweep_ref_light_slabs(
            lv.permute(p.perm), p, c["tcfg"])
        kw = dict(emission=c["tcfg"].emission)
        fwd, bwd = sweep_ref_fwd.sweep_ref_fwd_reference, \
            sweep_ref_bwd.sweep_ref_bwd_reference
    else:
        (stack, *args), flip = sweep_fwd.sweep_inputs(
            g.permute(p.perm), p, c["tcfg"], c["tmed"], c["tlight"])
        light = None if lv is None else sweep_fwd.sweep_light_stack(
            lv.permute(p.perm), p, c["tcfg"])
        kw = dict(emission=c["tcfg"].emission, flip=flip,
                  address_mode=c["tcfg"].address_mode)
        fwd, bwd = sweep_fwd.sweep_fwd_reference, \
            sweep_bwd.sweep_bwd_reference
    assert stack.dtype == torch.float32  # the cast is the node's
    return (build.stream_cast(stack, low), args,
            build.stream_cast(light, low), kw, fwd, bwd)


@pytest.mark.parametrize("case", [
    dict(eye=EYES[0]),
    dict(eye=EYES[2], lit=True),
    dict(eye=EYES[1], lit=True, mode="wrap"),
    dict(eye=EYES[0], emission=False),
    dict(eye=EYES[0], n_slices=24, lit=True),
    dict(eye=EYES[0], density=500.0, lit=True),
    dict(eye=EYES[0], combine="reference"),
    dict(eye=EYES[1], combine="reference", lit=True),
    dict(eye=EYES[2], combine="reference", emission=False),
], ids=["nolight", "light", "wrap-light", "absorption", "sub-voxel-light",
        "early-stop", "reference", "reference-light",
        "reference-absorption"])
def test_bf16_plain_backward_matches_autograd(case):
    """The closed-form plain backwards in the mode (what the bfloat16
    instantiations of K2 and K5 are held to on the card) against autograd
    of the plain forwards in the mode. Autograd through a bfloat16 tensor
    would round the gradient to bfloat16, so the forward is differentiated
    with _low=True on float32 tensors holding the bfloat16 values, which is
    the bfloat16 forward bit for bit. 2e-4 as in the float32 tests, 5e-4 in
    the early-stop case."""
    c = _setup(seed=3, **case)
    stack, args, light, kw, fwd, bwd = _kernel_inputs(c)
    cts = [torch.from_numpy(w) for w in c["wmaps"]]
    maps = fwd(stack, *args, light=light, **kw)
    st = stack.to(torch.float32).requires_grad_()
    lt = None if light is None else light.to(torch.float32).requires_grad_()
    fmaps = fwd(st, *args, light=lt, _low=True, **kw)
    for m, f in zip(maps, fmaps):
        assert torch.equal(m, f.detach())
    if case.get("density", 0.0) > 100.0:
        assert float(maps[1].min()) < 1e-3
    leaves = (st,) if lt is None else (st, lt)
    auto = torch.autograd.grad(_loss(fmaps, cts), leaves)
    got = bwd(stack, *args, *cts, maps[1], maps[2], light=light, **kw)
    got = (got,) if light is None else got
    tol = 5e-4 if case.get("density", 0.0) > 100.0 else 2e-4
    for g, a in zip(got, auto):
        assert g.dtype == torch.float32
        scale = float(a.abs().max())
        assert scale > 0.0
        torch.testing.assert_close(g, a, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_bf16_float32_path_unchanged(combine):
    """dtype="float32" takes no part of the new path: no cast (the very
    tensor goes on), unrounded weights, and the node returns the plain
    forward's float32 maps bit for bit; the bfloat16 maps differ."""
    c = _setup(EYES[0], combine=combine, lit=True)
    x = torch.from_numpy(c["grid"])
    assert build.stream_cast(x, False) is x
    assert build.stream_cast(None, True) is None
    xb = x.to(torch.bfloat16)
    assert build.stream_cast(xb, True) is xb
    f32 = dataclasses.replace(c["tcfg"], dtype="float32")
    got = _port_maps(c, f32)
    stack, args, light, kw, fwd, _ = _kernel_inputs(dict(c, tcfg=f32),
                                                    low=False)
    assert stack.dtype == light.dtype == torch.float32
    want = fwd(stack, *args, light=light, **kw)
    low = _port_maps(c)
    for g, w, b, n in zip(got, want, low, NAMES):
        assert torch.equal(g, w), n
        if n in ("trans", "wsum"):  # emission: acc stays 0
            assert not torch.equal(g, b), n
    u = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, 50)
                         .astype(np.float32))
    _, _, w0, w1 = linear_taps(u, 9, "mirror")
    f = u * 9 - 0.5
    f = f - torch.floor(f)
    assert torch.equal(w1, f) and torch.equal(w0, 1.0 - f)


def test_bf16_rounded_tap_matrix():
    """The mode's tap matrices are the float32 ones with every weight
    rounded to bfloat16 on its own; where clamping puts both taps of a row
    on one texel the entry is the sum of the two rounded weights."""
    u = torch.from_numpy(np.random.default_rng(1).uniform(-0.1, 1.1, 200)
                         .astype(np.float32))
    for mode in ("mirror", "clamp", "wrap"):
        a0, a1, w0, w1 = linear_taps(u, 7, mode)
        b0, b1, r0, r1 = linear_taps(u, 7, mode, round_bf16=True)
        assert torch.equal(a0, b0) and torch.equal(a1, b1)
        assert torch.equal(r0, build.bf16_round(w0))
        assert torch.equal(r1, build.bf16_round(w1))
        W = linear_resample_matrix(u, 7, mode, round_bf16=True)
        want = torch.zeros((200, 7))
        want[torch.arange(200), a0] += r0
        want[torch.arange(200), a1] += r1
        assert torch.equal(W, want)
    # the rounded pair sums to 1 only to within 2^-8
    s = r0 + r1
    assert float((s - 1.0).abs().max()) <= 2.0 ** -8
    assert float((s - 1.0).abs().max()) > 0.0


def test_bf16_round_matches_jax_bit_for_bit():
    """build.bf16_round against jnp's astype(bfloat16) on seeded values,
    ties included (round to nearest even), and the numpy bridge for a
    bfloat16 grid: float32 out of JAX, .to(torch.bfloat16) in, exact both
    ways."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4096), rng.uniform(0.0, 1.0, 4096),
        rng.uniform(-1e-3, 1e-3, 512)]).astype(np.float32)
    # exact ties: a bfloat16 value plus half a bfloat16 ulp, odd and even
    base = (x[:1024].view(np.uint32) & np.uint32(0xFFFF0000))
    ties = (base | np.uint32(0x8000)).view(np.float32)
    x = np.concatenate([x, ties, np.array([0.0, -0.0, 1.0, 1.0 - 2.0 ** -9,
                                           1.0 + 2.0 ** -8], np.float32)])
    jb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jb.astype(jnp.float32))
    got = build.bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[-1029:-5] != ties).all()  # every tie moved
    # the bridge
    across = torch.from_numpy(np.asarray(jb, dtype=np.float32)) \
        .to(torch.bfloat16)
    assert torch.equal(across.to(torch.float32), torch.from_numpy(want))
    back = jnp.asarray(across.to(torch.float32).numpy()).astype(jnp.bfloat16)
    assert bool((back == jb).all())


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_bf16_gradient_dtype_follows_the_grid(combine):
    """A float32 grid gets a float32 gradient that is not rounded to
    bfloat16 (the cast lives inside the node); a grid that arrives in
    bfloat16 is swept without a copy and gets a bfloat16 gradient, the
    float32 one rounded (tests/test_bf16.py asserts dg.dtype ==
    gperm.dtype); the maps are the same either way."""
    c = _setup(EYES[0], combine=combine, lit=combine == "single")
    cts = [torch.from_numpy(w) for w in c["wmaps"]]
    grid = build.bf16_round(torch.from_numpy(c["grid"]))
    lv = _topt(c["lvol"])
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        g = grid.to(dt).detach().clone().requires_grad_()
        maps = _port_base(c, g, lv)
        _loss(maps, cts).backward()
        assert g.grad.dtype == dt
        out[dt] = (maps, g.grad)
    for a, b in zip(out[torch.float32][0], out[torch.bfloat16][0]):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    g32, g16 = out[torch.float32][1], out[torch.bfloat16][1]
    assert bool(torch.isfinite(g32).all()) and float(g32.abs().max()) > 0
    assert not torch.equal(g32, build.bf16_round(g32))
    if combine == "single":
        # one cast of the float32 gradient (the 4-channel slab build adds
        # bfloat16 autograd steps of its own)
        assert torch.equal(g16, g32.to(torch.bfloat16))
    else:
        torch.testing.assert_close(g16.to(torch.float32), g32, rtol=2e-2,
                                   atol=2e-2 * float(g32.abs().max()))


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_bf16_node_saves_the_bfloat16_copy(combine):
    """The node saves the bfloat16 stack it swept (half the bytes, and the
    very texels the backward's replay must read), not the float32 input."""
    c = _setup(EYES[0], combine=combine, lit=True)
    g = _topt(c["grid"]).requires_grad_()
    lv = _topt(c["lvol"]).requires_grad_()
    maps = _port_base(c, g, lv)
    saved = maps[1].grad_fn.saved_tensors
    big = [t for t in saved if t.dim() >= 3]
    assert len(big) == 2 and all(t.dtype == torch.bfloat16 for t in big)
    f32 = dataclasses.replace(c["tcfg"], dtype="float32")
    maps = _port_base(c, g, lv, f32)
    big = [t for t in maps[1].grad_fn.saved_tensors if t.dim() >= 3]
    assert all(t.dtype == torch.float32 for t in big)


def test_bf16_render_image_gradient_matches_jax():
    """The slice as a whole: render_image in the mode, image and d/dgrid of
    sum(rgb^2), against the JAX jnp sweep at bfloat16 on the FBM cloud."""
    cloud = np.asarray(J.cloud_volume(16, seed=7))
    kw = dict(emission=True, quadrature="sliced", dtype="bfloat16")
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    jmed = J.MediumConfig(combine="single", density=8.0)
    tmed = T.MediumConfig(combine="single", density=8.0)
    cam_kw = dict(width=48, height=32)
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(**cam_kw)),
                              cloud.shape, jcfg)

    def loss(g):
        img = jsweep.sweep_render(g, jplan, jcfg, jmed, use_pallas=False)
        return jnp.sum(img[..., :3] ** 2), img
    (_, want), gwant = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(cloud))
    g = torch.from_numpy(cloud.copy()).requires_grad_()
    got = T.render_image(g, T.make_camera(T.CameraConfig(**cam_kw)), tcfg,
                         tmed, plan=torch_plan(jplan))
    (got[..., :3] ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    gwant = np.asarray(gwant, dtype=np.float32)
    assert g.grad.dtype == torch.float32
    np.testing.assert_allclose(g.grad.numpy(), gwant, rtol=GRAD_TOL,
                               atol=GRAD_TOL * float(np.abs(gwant).max()))


def test_bf16_cpu_sweep_launches_no_kernel():
    c = _setup(EYES[0], lit=True)
    mods = (sweep_fwd, sweep_bwd, sweep_ref_fwd, sweep_ref_bwd)
    before = [m.launches for m in mods]
    _port_grads(c)
    _port_grads(_setup(EYES[0], combine="reference"))
    assert [m.launches for m in mods] == before


def test_bf16_launch_refuses_cpu_and_mixed_streams():
    """check_sweep_inputs: CPU tensors are refused whatever their type."""
    c = _setup(EYES[0], lit=True)
    stack, args, light, kw, _, _ = _kernel_inputs(c)
    before = sweep_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        sweep_fwd.launch_kernel(stack, *args, True, kw["flip"], False,
                                light)
    assert sweep_fwd.launches == before
