"""The preset front end of the port (scene_sigma, prepare_baked_scene,
render_scene, render_preset, the "fixed" quadrature and the per-ray
fallback of render_image, `cli render` and `cli info`) against the JAX
package's functions of the same names, at reduced sizes on the CPU.

Where a grid is shared (made once, handed to both packages as numpy) the
images are held to the render tests' rtol=2e-4 with atol=1e-4 (the two
packages' cameras and plans differ in float32 rounding, which moves a
pixel's taps by ~4e-5 base texels). Where each package builds its own
procedural volume the grids themselves differ by up to 1e-5
(tests/test_torch_noise_scene.py), amplified by the medium's density: those
images are held to atol=1e-3.
"""
import dataclasses
import logging
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from test_torch_serve import _free_port
from test_torch_sweep_fwd import torch_plan
from volumetricrenderer_tpu.models import scene as jscene
from volumetricrenderer_tpu.ops import integrate as jint
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu.render import \
    prepare_baked_scene as jprepare_baked_scene
from volumetricrenderer_tpu.render import render_scene as jrender_scene
from volumetricrenderer_tpu_torch import cli
from volumetricrenderer_tpu_torch.kernels import sweep_bwd, sweep_fwd, \
    sweep_ref_bwd, sweep_ref_fwd
from volumetricrenderer_tpu_torch.models import scene as tscene
from volumetricrenderer_tpu_torch.ops import integrate as tint
from volumetricrenderer_tpu_torch.ops.sweep import sweep_render
from volumetricrenderer_tpu_torch.utils import clock, sanitize

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
OWN_ATOL = 1e-3  # each package builds its own procedural volume

JCFG = J.RenderConfig(emission=True, quadrature="sliced")
TCFG = T.RenderConfig(emission=True, quadrature="sliced")
JMED = J.MediumConfig(combine="single", density=8.0)
TMED = T.MediumConfig(combine="single", density=8.0)


def read_png(path):
    """Decode an 8-bit PNG written by utils/image.write_png (one IDAT,
    filter type 0 on every row) to a (H, W, C) uint8 array."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[tag] = data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8) \
        .reshape(h, 1 + w * c)
    assert depth == 8 and not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, c)


def _small(package, name, size=16, width=48, height=32, max_steps=32):
    """A preset cut to test size, in either package."""
    p = package.get_preset(name)
    return dataclasses.replace(
        p, volume=dataclasses.replace(p.volume, size=size),
        camera=dataclasses.replace(p.camera, width=width, height=height),
        render=dataclasses.replace(p.render, max_steps=max_steps))


def _scene_pair(n=16):
    """A two-volume scene with voxel-aligned translations in both packages,
    from the same numpy grids."""
    cloud = np.asarray(J.cloud_volume(n, seed=3))
    smoke = np.asarray(jscene.smoke_volume(n, seed=5))
    t1, t2 = 2 * 2.0 / n, -3 * 2.0 / n
    jvols = [jscene.Volume(jnp.asarray(cloud),
                           jscene.translate_w2l(0.0, 0.0, t1)),
             jscene.Volume(jnp.asarray(smoke),
                           jscene.translate_w2l(t2, 0.0, 0.0))]
    cpu = dict(device="cpu")
    tvols = [tscene.Volume(torch.from_numpy(cloud.copy()),
                           tscene.translate_w2l(0.0, 0.0, t1, **cpu)),
             tscene.Volume(torch.from_numpy(smoke.copy()),
                           tscene.translate_w2l(t2, 0.0, 0.0, **cpu))]
    return jvols, tvols


# --- scene_sigma -----------------------------------------------------------

@pytest.mark.parametrize("combine", ["single", "reference"])
def test_scene_sigma_matches_jax(combine):
    """Summed extinction of two translated volumes at seeded positions,
    some outside a volume's own box (zero there), against the JAX
    function; float32 rounding of the transforms only (atol 1e-6)."""
    rng = np.random.default_rng(0)
    shape = (8, 8, 8) if combine == "single" else (8, 8, 8, 4)
    g1 = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    g2 = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (60, 3)).astype(np.float32)
    scroll = None if combine == "single" else \
        rng.uniform(-1.5, 1.5, (4, 3)).astype(np.float32)
    jmed, tmed = J.MediumConfig(combine=combine), \
        T.MediumConfig(combine=combine)
    want = np.asarray(jint.scene_sigma(
        [jscene.Volume(jnp.asarray(g1), jscene.translate_w2l(0.5, 0.0, 0.0)),
         jscene.Volume(jnp.asarray(g2))], jnp.asarray(pos), JCFG, jmed,
        None if scroll is None else jnp.asarray(scroll)))
    tvols = [tscene.Volume(torch.from_numpy(g1),
                           tscene.translate_w2l(0.5, 0.0, 0.0,
                                                device="cpu")),
             tscene.Volume(torch.from_numpy(g2))]
    got = tint.scene_sigma(tvols, torch.from_numpy(pos), TCFG, tmed,
                           None if scroll is None
                           else torch.from_numpy(scroll))
    assert got.shape == (60,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # densities add; outside its own box a volume contributes nothing
    alone = [tint.scene_sigma([v], torch.from_numpy(pos), TCFG, tmed,
                              None if scroll is None
                              else torch.from_numpy(scroll)) for v in tvols]
    torch.testing.assert_close(got, alone[0] + alone[1], rtol=1e-6, atol=0)
    outside = torch.from_numpy(pos)[:, 0] < 0.25  # local x < 0
    assert bool(outside.any()) and bool((alone[0][outside] == 0.0).all())
    assert bool((alone[0][~outside] > 0.0).all())


def test_scene_sigma_identity_is_sample_sigma():
    g = torch.from_numpy(np.array(J.cloud_volume(8, seed=3)))
    pos = torch.from_numpy(np.random.default_rng(0).random((40, 3))
                           .astype(np.float32))
    torch.testing.assert_close(
        tint.scene_sigma([tscene.Volume(g)], pos, TCFG, TMED),
        tint.sample_sigma(g, pos, TMED, None, TCFG.address_mode), rtol=0,
        atol=0)


# --- prepare_baked_scene, render_scene ---------------------------------------

def test_prepare_baked_scene_matches_jax():
    jvols, tvols = _scene_pair()
    jg, jm, js = jprepare_baked_scene(jvols, JCFG, JMED)
    tg, tm, ts = T.prepare_baked_scene(tvols, TCFG, TMED)
    assert js is None and ts is None and tm == TMED
    assert tg.shape == (16, 16, 16)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    # bare grids are volumes with the identity transform; bake_size
    g = tvols[0].grid
    tg, _, _ = T.prepare_baked_scene([g], TCFG, TMED, bake_size=8)
    jg, _, _ = jprepare_baked_scene([jvols[0].grid], JCFG, JMED,
                                     bake_size=8)
    assert tg.shape == (8, 8, 8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_prepare_baked_scene_reference_combine_matches_jax():
    """With the 4-channel combine each volume's sigma is materialized
    first (the scroll folds in), and the medium that comes back is the
    equivalent single-channel one with no scroll."""
    rng = np.random.default_rng(2)
    g4 = rng.uniform(0.1, 1.0, (12, 12, 12, 4)).astype(np.float32)
    scroll = rng.uniform(-1.5, 1.5, (4, 3)).astype(np.float32)
    jg, jm, js = jprepare_baked_scene(
        [jscene.Volume(jnp.asarray(g4), jscene.translate_w2l(0.0, 1 / 3, 0))],
        JCFG, J.MediumConfig(density=3.0), scroll=jnp.asarray(scroll))
    tg, tm, ts = T.prepare_baked_scene(
        [tscene.Volume(torch.from_numpy(g4),
                       tscene.translate_w2l(0.0, 1 / 3, 0, device="cpu"))],
        TCFG, T.MediumConfig(density=3.0), scroll=torch.from_numpy(scroll))
    assert js is None and ts is None
    assert (tm.combine, tm.sample_scale, tm.density) == \
        (jm.combine, jm.sample_scale, jm.density) == ("single", 1.0, 3.0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend,quadrature", [
    ("auto", "sliced"), ("sweep", "sliced"), ("reference", "sliced"),
    ("reference", "fixed"), ("auto", "fixed")])
def test_render_scene_matches_jax(backend, quadrature):
    """Both backends of render_scene: the bake and the slice sweep, and
    the per-ray march against the exact per-volume fields (sliced oracle
    and fixed-step)."""
    jvols, tvols = _scene_pair()
    cam_kw = dict(eye=(2.5, 2.2, 2.8), width=40, height=28)
    jcfg = dataclasses.replace(JCFG, quadrature=quadrature, max_steps=48)
    tcfg = dataclasses.replace(TCFG, quadrature=quadrature, max_steps=48)
    want = np.asarray(jrender_scene(
        jvols, J.make_camera(J.CameraConfig(**cam_kw)), jcfg, JMED,
        backend=backend))
    got = T.render_scene(tvols, T.make_camera(T.CameraConfig(**cam_kw)),
                         tcfg, TMED, backend=backend)
    assert got.shape == want.shape == (28, 40, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(got[..., 3].max()) > 0.1


def test_render_scene_sweep_close_to_exact_fields():
    """The baked sweep against the per-ray oracle on the exact fields:
    the integral is the same up to the bake's and the warp's resampling
    (tests/test_scene_multi.py's bound is the same order)."""
    _, tvols = _scene_pair()
    cam = T.make_camera(T.CameraConfig(eye=(2.5, 2.2, 2.8), width=40,
                                       height=28))
    swept = T.render_scene(tvols, cam, TCFG, TMED)
    exact = T.render_scene(tvols, cam, TCFG, TMED, backend="reference")
    assert float((swept - exact).abs().mean()) < 2e-2
    with pytest.raises(ValueError, match="unknown combine"):
        T.render_scene(tvols, cam, TCFG,
                       dataclasses.replace(TMED, combine="other"))


# --- render_preset -----------------------------------------------------------

@pytest.mark.parametrize("name,t", [("config1", 0.0), ("config2", 1.7),
                                    ("config4", 0.0), ("reference", 1.7)])
def test_render_preset_matches_jax_on_one_grid(name, t):
    """render_preset at reduced size, the grid built once by the JAX
    package and handed to both: the single-channel presets' (D, H, W, 1)
    grid and scroll reach the port's single-channel sweep (the JAX package
    sends them to its general jnp sweep: same function), config4 with its
    light volume; the `reference` preset marches per ray."""
    jp, tp = _small(J, name), _small(T, name)
    grid = np.asarray(J.build_volume(jp.volume))
    assert grid.shape == (16, 16, 16, 4 if name == "reference" else 1)
    want = np.asarray(J.render_preset(jp, t=t, grid=jnp.asarray(grid)))
    mods = (sweep_fwd, sweep_bwd, sweep_ref_fwd, sweep_ref_bwd)
    before = [m.launches for m in mods]
    got = T.render_preset(tp, t=t, grid=torch.from_numpy(grid.copy()))
    assert [m.launches for m in mods] == before  # a CPU grid: plain versions
    assert got.shape == want.shape == (32, 48, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(got[..., 3].max()) > 0.01
    if name == "config4":  # the shadows are in the frame
        lit = T.render_preset(dataclasses.replace(tp, light=T.LightConfig()),
                              grid=torch.from_numpy(grid.copy()))
        assert float((lit[..., :3] - got[..., :3]).max()) > 1e-3


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4",
                                  "reference"])
def test_render_preset_builds_its_own_volume(name):
    """render_preset with no grid: each package builds the preset's volume
    (config3: its two-volume scene, baked) and renders it; device="cpu" is
    the caller asking for the CPU."""
    want = np.asarray(J.render_preset(_small(J, name), t=0.7))
    got = T.render_preset(_small(T, name), t=0.7, device="cpu")
    assert got.device.type == "cpu" and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=OWN_ATOL)
    assert float(got[..., 3].max()) > 0.01


def test_render_preset_bfloat16():
    """RenderConfig(dtype="bfloat16") through render_preset: within
    tests/test_bf16.py's 3e-2 max / 3e-3 mean of the float32 frame."""
    tp = _small(T, "config2")
    grid = T.build_volume(tp.volume, device="cpu")
    a = T.render_preset(tp, grid=grid)
    b = T.render_preset(dataclasses.replace(
        tp, render=dataclasses.replace(tp.render, dtype="bfloat16")),
        grid=grid)
    d = (a - b).abs()
    assert 0.0 < float(d.max()) < 3e-2 and float(d.mean()) < 3e-3


def test_render_preset_defaults_to_the_gpu():
    """No entry point picks the CPU by itself: without a GPU the default
    device raises torch's own error."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        T.render_preset(_small(T, "config1"))


# --- the "fixed" quadrature, the fallback, the (D, H, W, 1) form ------------

@pytest.mark.parametrize("combine", ["single", "reference"])
def test_fixed_quadrature_matches_jax(combine):
    """quadrature="fixed" through render_image is the per-ray march
    (render_rays), for backend "auto" and "reference"."""
    rng = np.random.default_rng(1)
    if combine == "single":
        grid, scroll = np.asarray(J.cloud_volume(16, seed=7)), None
        jmed, tmed = JMED, TMED
    else:
        grid = rng.uniform(0.1, 1.0, (16, 16, 16, 4)).astype(np.float32)
        scroll = np.array(J.reference_media_scroll(1.7))
        jmed, tmed = J.MediumConfig(density=4.0), T.MediumConfig(density=4.0)
    cam_kw = dict(eye=(3.0, 2.0, 2.5), width=40, height=28)
    jcfg = J.RenderConfig(emission=True, max_steps=48)
    tcfg = T.RenderConfig(emission=True, max_steps=48)
    assert jcfg.quadrature == tcfg.quadrature == "fixed"
    want = np.asarray(J.render_image(
        jnp.asarray(grid), J.make_camera(J.CameraConfig(**cam_kw)), jcfg,
        jmed, scroll=None if scroll is None else jnp.asarray(scroll)))
    tcam = T.make_camera(T.CameraConfig(**cam_kw))
    g = torch.from_numpy(grid.copy())
    ts = None if scroll is None else torch.from_numpy(scroll)
    got = T.render_image(g, tcam, tcfg, tmed, scroll=ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        T.render_image(g, tcam, tcfg, tmed, scroll=ts, backend="reference"),
        got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sliced"):
        T.render_image(g, tcam, tcfg, tmed, scroll=ts, backend="pallas")


def test_no_sweep_axis_falls_back_loudly(caplog):
    """A camera whose rays straddle an axis plane admits no sweep axis:
    backend "auto" warns and marches per ray, as the JAX package does;
    backend "sweep" raises."""
    grid = np.asarray(J.cloud_volume(8, seed=3))
    cam_kw = dict(eye=(3.0, 0.0, 0.0), fov_y_degrees=175.0, width=16,
                  height=16)
    want = np.asarray(J.render_image(
        jnp.asarray(grid), J.make_camera(J.CameraConfig(**cam_kw)), JCFG,
        JMED))
    tcam = T.make_camera(T.CameraConfig(**cam_kw))
    g = torch.from_numpy(grid.copy())
    with caplog.at_level(logging.WARNING,
                         logger="volumetricrenderer_tpu_torch"):
        got = T.render_image(g, tcam, TCFG, TMED)
    assert any("no sweep axis" in r.getMessage()
               and "per-ray" in r.getMessage() for r in caplog.records)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        T.render_image(g, tcam, TCFG, TMED, backend="sweep")


@pytest.mark.parametrize("emission", [True, False])
def test_single_channel_4d_grid_and_scroll_match_jax(emission):
    """combine="single" is "channel 0, the scroll is ignored": a
    (D, H, W, C) grid with a scroll through the port's single-channel
    sweep against the JAX package's general jnp sweep on the same plan
    (the render tests' rtol=2e-4, atol=2e-5), and equal to the 3-D sweep
    of channel 0 bit for bit."""
    rng = np.random.default_rng(4)
    grid = rng.uniform(0.2, 1.0, (16, 16, 16, 2)).astype(np.float32)
    scroll = rng.uniform(-1.5, 1.5, (2, 3)).astype(np.float32)
    jcfg = dataclasses.replace(JCFG, emission=emission)
    tcfg = dataclasses.replace(TCFG, emission=emission)
    jplan = jsweep.plan_sweep(
        J.make_camera(J.CameraConfig(eye=(-2.5, 0.8, -1.0), width=96,
                                     height=64)), grid.shape, jcfg)
    want = np.asarray(jsweep.sweep_render(
        jnp.asarray(grid), jplan, jcfg, JMED, scroll=jnp.asarray(scroll),
        use_pallas=False))
    g = torch.from_numpy(grid.copy()).requires_grad_()
    got = sweep_render(g, torch_plan(jplan), tcfg, TMED,
                       scroll=torch.from_numpy(scroll))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=2e-5)
    flat = sweep_render(g.detach()[..., 0], torch_plan(jplan), tcfg, TMED)
    assert torch.equal(got.detach(), flat)
    # the gradient reaches channel 0 only
    (got[..., :3] ** 2).sum().backward()
    assert float(g.grad[..., 0].abs().max()) > 0.0
    assert float(g.grad[..., 1].abs().max()) == 0.0


# --- cli render / info, utils ------------------------------------------------

@pytest.mark.parametrize("name", ["config1", "config3", "reference"])
def test_cli_render_writes_the_presets_frame(tmp_path, name):
    out = str(tmp_path / f"{name}.png")
    args = ["render", "--preset", name, "--volume-size", "12", "--width",
            "24", "--height", "16", "--time", "0.7", "--out", out,
            "--device", "cpu", "--check-nan"]
    assert cli.main(args) == 0
    got = read_png(out)
    assert got.shape == (16, 24, 4)
    p = T.get_preset(name)
    p = dataclasses.replace(
        p, volume=dataclasses.replace(p.volume, size=12),
        camera=dataclasses.replace(p.camera, width=24, height=16))
    want = T.render_preset(p, t=0.7, device="cpu")
    want8 = np.round(np.clip(want.numpy(), 0.0, 1.0) * 255.0)
    assert np.abs(got.astype(np.float64) - want8).max() <= 1.0


def test_cli_render_options(tmp_path, capsys):
    """--backend sweep is the slice sweep, --backend reference the per-ray
    oracle, and the JAX CLI's "pallas" alias is no choice here;
    --profile-dir writes a trace; an unknown preset exits with code 2."""
    base = ["render", "--preset", "config2", "--volume-size", "12",
            "--width", "24", "--height", "16", "--device", "cpu"]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert cli.main(base + ["--out", a, "--backend", "sweep"]) == 0
    with pytest.raises(SystemExit) as e:
        cli.main(base + ["--out", a, "--backend", "pallas"])
    assert e.value.code == 2
    capsys.readouterr()
    assert cli.main(base + ["--out", b, "--backend", "reference",
                            "--profile-dir", str(tmp_path / "prof")]) == 0
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    d = np.abs(read_png(a).astype(np.int64) - read_png(b).astype(np.int64))
    assert d.mean() < 8.0  # the same integral up to the warp's resampling
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--preset", "config9", "--device", "cpu"])
    assert e.value.code == 2
    assert "unknown preset" in capsys.readouterr().err


SLICED_REFERENCE = ["--preset", "reference", "--quadrature", "sliced",
                    "--volume-size", "16", "--width", "32", "--height", "24",
                    "--device", "cpu"]


@pytest.mark.parametrize("cmd", ["render", "animate", "serve"])
def test_cli_reference_preset_sliced_takes_the_four_channel_sweep(
        tmp_path, monkeypatch, capsys, cmd):
    """--quadrature sliced sends the reference preset's (16, 16, 16, 4) grid
    through the 4-channel sweep's plain version on the CPU, in every
    subcommand that renders: never the per-ray march, never the general
    sweep. `render` gives render_preset's frame of the same preset."""
    import importlib
    from volumetricrenderer_tpu_torch.ops import sweep as tsweep
    render_mod = importlib.import_module("volumetricrenderer_tpu_torch.render")
    swept, plain = [], sweep_ref_fwd.sweep_ref_fwd_reference

    def spy(L, *a, **kw):
        swept.append(tuple(L.shape))
        return plain(L, *a, **kw)

    def march(*a, **kw):
        raise AssertionError("the per-ray march ran")
    monkeypatch.setattr(sweep_ref_fwd, "sweep_ref_fwd_reference", spy)
    monkeypatch.setattr(render_mod, "render_rays", march)
    general = tsweep.general_calls
    out = tmp_path / "out"
    extra = {"render": ["--time", "0.7", "--out", str(out) + ".png"],
             "animate": ["--frames", "2", "--out-dir", str(out)],
             "serve": ["--selftest-frames", "1", "--port",
                       str(_free_port())]}[cmd]
    assert cli.main([cmd] + SLICED_REFERENCE + extra) == 0
    assert swept and set(swept) == {(16, 4, 16, 16)}
    assert tsweep.general_calls == general
    if cmd == "animate":
        assert sorted(os.listdir(out))[:2] == ["frame_00000.png",
                                               "frame_00001.png"]
        assert read_png(str(out / "frame_00001.png")).shape == (24, 32, 4)
    elif cmd == "serve":
        import json
        report = json.loads(capsys.readouterr().out)
        assert report["frames"] == 1 and report["preset"] == "reference"
        assert (report["width"], report["height"]) == (32, 24)
    else:
        p = T.get_preset("reference")
        p = dataclasses.replace(
            p, volume=dataclasses.replace(p.volume, size=16),
            camera=dataclasses.replace(p.camera, width=32, height=24),
            render=dataclasses.replace(p.render, quadrature="sliced"))
        want = T.render_preset(p, t=0.7, device="cpu")
        want8 = np.round(np.clip(want.numpy(), 0.0, 1.0) * 255.0)
        got = read_png(str(out) + ".png").astype(np.float64)
        assert np.abs(got - want8).max() <= 1.0


def test_cli_serve_reference_preset_without_sliced_still_refuses(caplog):
    """Without --quadrature the reference preset keeps its "fixed"
    quadrature, which the live loop's sweep refuses, as before: the frame
    fails and the server drops the self-drive's connection."""
    args = [a for a in SLICED_REFERENCE if a not in ("--quadrature",
                                                     "sliced")]
    with pytest.raises(ConnectionError):
        cli.main(["serve"] + args + ["--selftest-frames", "1", "--port",
                                     str(_free_port())])
    assert 'backend "sweep" requires quadrature "sliced"' in caplog.text


def test_cli_info(capsys):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "torch:" in out
    for name in T.PRESETS:
        assert f"preset {name}:" in out


@pytest.mark.parametrize("args", [
    ["info"],
    ["render", "--preset", "config1", "--volume-size", "8", "--width", "8",
     "--height", "8"],
    ["fit", "--size", "6", "--image-size", "8", "--steps", "1"],
    ["animate", "--preset", "config1", "--volume-size", "8", "--width",
     "8", "--height", "8", "--frames", "1"],
    ["serve", "--preset", "config1", "--selftest-frames", "1", "--port",
     "0"]],
    ids=["info", "render", "fit", "animate", "serve"])
def test_cli_default_device_fails_without_a_gpu(tmp_path, monkeypatch, args):
    """--device defaults to cuda on every subcommand; with no GPU and no
    --device cpu the command fails with torch's own error instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    monkeypatch.chdir(tmp_path)
    if args[0] in ("fit", "animate"):
        args = args + ["--out-dir", str(tmp_path / "run")]
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(args)
    assert not (tmp_path / "frame.png").exists()
    assert not list(tmp_path.rglob("*.png"))


def test_checked_names_the_first_nonfinite_output():
    def good(x):
        return {"img": x, "aux": (x * 2.0, 3)}

    def bad(x):
        return {"img": x, "aux": (x / 0.0, x)}
    x = torch.ones(4)
    assert sanitize.checked(good)(x)["img"] is x
    with pytest.raises(FloatingPointError, match=r"bad.*\['aux'\]\[0\].*4"):
        sanitize.checked(bad)(x)
    assert sanitize.first_nonfinite(good(x)) == {}
    assert sanitize.first_nonfinite([x, torch.tensor([float("nan")])]) == \
        {"[1]": 1}
    with pytest.raises(ValueError, match="state"):
        sanitize.assert_all_finite({"w": torch.tensor([float("inf")])},
                                   "state")
    sanitize.assert_all_finite({"w": x, "step": 3, "name": "run"})


def test_clock_and_device_timer_on_the_cpu():
    c = clock.Clock()
    assert c.elapsed() >= 0.0
    assert c.stamp() >= 0.0 and c.elapsed() < 5.0
    x = torch.ones(8)
    assert clock.sync(x) is x and clock.sync((x, {"a": x})) is not None
    calls = []

    def fn(y, scale=1.0):
        calls.append(1)
        return y * scale
    out, seconds = clock.device_timer(fn, x, warmup=0, iters=3, scale=2.0)
    assert len(calls) == 4 and seconds >= 0.0  # one warm-up at least
    torch.testing.assert_close(out, x * 2.0)
