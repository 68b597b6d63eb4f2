"""The port's bench (volumetricrenderer_tpu_torch/bench.py, bench_torch.py)
and the route switch it needs, against the JAX package on the CPU:

* sweep_render(use_kernels=False), the general sweep on a configuration
  the kernels cover, against JAX sweep_render(use_pallas=False), with the
  port's default route beside it;
* the general sweep's checkpointed chunk (chunk=), use_kernels=True where
  no kernel covers the configuration, the same two arguments on the
  slab-sharded sweep (a one-process gloo mesh);
* early_exit_rate against bench.py's exit_rate expression;
* main() at 16^3 / 48x32 on the CPU, and the default device without a GPU.

Inputs are drawn from seeded numpy generators. Tolerances: frames rtol=2e-4,
atol=2e-5 (tests/test_sweep_pallas.py, as tests/test_torch_render.py holds
the image); a chunked gradient within 1e-6 relative of the default chunk's
(the same arithmetic, recomputed in other groups); the sharded general
sweep on a 1x1 mesh bit for bit for the single medium (the same layers:
slice planes at texel centers, so the layer lerp's fraction is exactly 0),
within 1e-6 for the reference medium (its channel slabs lerped first).
"""
import contextlib
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from test_torch_sweep_fwd import torch_plan
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu_torch import bench as tbench
from volumetricrenderer_tpu_torch.ops import sweep as tsweep
from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh
from volumetricrenderer_tpu_torch.parallel.sweep_sharded import \
    sweep_render_sharded

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
D = 16
EYES = {"x-": (3.0, 0.4, 0.3), "z+": (0.4, 0.3, -3.0), "y-": (0.3, 3.0, 0.4),
        "default": (3.0, 3.0, 3.0)}
SMALL = {"VOLT_BENCH_VOLUME": "16", "VOLT_BENCH_WIDTH": "48",
         "VOLT_BENCH_HEIGHT": "32"}
# bench.py:262-285's keys with the TPU-only ones mapped, and the new ones
LINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "volume", "image",
    "grad_allclose_vs_reference", "ms_per_frame_fwd_bwd",
    "ms_per_frame_fwd_bwd_quartiles", "host_ms_per_frame_fwd_bwd",
    "kernels_vs_general", "ms_per_frame_general", "ms_per_frame_bf16",
    "bf16_speedup", "device", "power_limit_w", "early_exit_rate_flagship",
    "early_exit_rate_dense", "base_shape", "timed_runs", "warmup_runs",
    "peak_memory_gib", "launches_per_step", "general_sweep_calls",
    "bench_total_s")


def _grid(combine, seed=0):
    rng = np.random.default_rng(seed)
    shape = (D, D, D, 4) if combine == "reference" else (D, D, D)
    return rng.uniform(0.1, 1.0, shape).astype(np.float32)


def _case(combine, emission, eye, mode="mirror"):
    kw = dict(emission=emission, quadrature="sliced", address_mode=mode)
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    if combine == "reference":
        jmed, tmed = J.MediumConfig(density=4.0), T.MediumConfig(density=4.0)
    else:
        jmed = J.MediumConfig(combine="single", density=8.0)
        tmed = T.MediumConfig(combine="single", density=8.0)
    shape = (D, D, D, 4) if combine == "reference" else (D, D, D)
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(
        eye=EYES[eye], width=48, height=32)), shape, jcfg)
    return jcfg, tcfg, jmed, tmed, jplan, torch_plan(jplan)


def _scroll(combine):
    if combine != "reference":
        return None
    return np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)


def _render(grid, plan, cfg, med, scroll=None, **kw):
    """(frame, the general sweep's calls during it)."""
    calls = tsweep.general_calls
    img = tsweep.sweep_render(
        grid, plan, cfg, med,
        scroll=None if scroll is None else torch.from_numpy(scroll), **kw)
    return img, tsweep.general_calls - calls


@pytest.mark.parametrize("combine,emission,eye", [
    ("single", True, "x-"), ("single", False, "z+"),
    ("reference", True, "y-")])
def test_general_route_matches_jax(combine, emission, eye):
    """use_kernels=False takes the general sweep on a configuration the
    kernels cover, once per frame; the default route takes the kernels'
    plain versions and no general sweep; both equal JAX's jnp sweep (run
    with chunk=1: the frame does not depend on the chunk, and a one-slice
    scan body compiles fastest)."""
    grid, scroll = _grid(combine), _scroll(combine)
    jcfg, tcfg, jmed, tmed, jplan, tplan = _case(combine, emission, eye)
    want = np.asarray(jsweep.sweep_render(
        jnp.asarray(grid), jplan, jcfg, jmed,
        scroll=None if scroll is None else jnp.asarray(scroll), chunk=1,
        use_pallas=False))
    general, n_general = _render(torch.from_numpy(grid), tplan, tcfg, tmed,
                                 scroll, use_kernels=False)
    default, n_default = _render(torch.from_numpy(grid), tplan, tcfg, tmed,
                                 scroll)
    assert (n_general, n_default) == (1, 0)
    assert float(general[..., 3].max()) > 0.0
    for got in (general, default):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunk_keeps_frame_and_gradient(chunk):
    """The general sweep's checkpointed chunk changes what the backward
    recomputes, not the function: the frame bit for bit, the grid gradient
    within 1e-6 relative of the default chunk's (about sqrt(16) = 4)."""
    grid = _grid("single", seed=1)
    _, tcfg, _, tmed, _, tplan = _case("single", True, "default")
    out = []
    for c in (None, chunk):
        g = torch.from_numpy(grid.copy()).requires_grad_()
        img = tsweep.sweep_render(g, tplan, tcfg, tmed, chunk=c,
                                  use_kernels=False)
        (img[..., :3] ** 2).sum().backward()
        out.append((img.detach(), g.grad))
    (img0, g0), (img1, g1) = out
    assert torch.equal(img0, img1)
    scale = float(g0.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-6,
                               atol=1e-6 * scale)


def test_use_kernels_true():
    """use_kernels=True: the kernels' route where one covers the
    configuration (the default frame bit for bit), NotImplementedError
    where none does (the reference medium with clamp addressing)."""
    grid = _grid("single", seed=2)
    _, tcfg, _, tmed, _, tplan = _case("single", True, "x-")
    forced, n = _render(torch.from_numpy(grid), tplan, tcfg, tmed,
                        use_kernels=True)
    default, _ = _render(torch.from_numpy(grid), tplan, tcfg, tmed)
    assert n == 0 and torch.equal(forced, default)
    grid4, scroll = _grid("reference"), _scroll("reference")
    _, tcfg, _, tmed, _, tplan = _case("reference", True, "y-", "clamp")
    with pytest.raises(NotImplementedError, match="no kernel covers"):
        _render(torch.from_numpy(grid4), tplan, tcfg, tmed, scroll,
                use_kernels=True)
    _, n = _render(torch.from_numpy(grid4), tplan, tcfg, tmed, scroll)
    assert n == 1  # the automatic fallback still takes the general sweep


@contextlib.contextmanager
def _one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("combine,emission,eye", [
    ("single", True, "x-"), ("single", False, "z+"),
    ("reference", True, "y-")])
def test_sharded_general_route(tmp_path, combine, emission, eye):
    """sweep_render_sharded(use_kernels=False) on a 1x1 gloo mesh: one
    general sweep over the rank's slabs, the frame and the grid gradient
    equal to sweep_render(use_kernels=False)'s: bit for bit for the single
    medium; within 1e-6 (of the gradient's maximum) for the reference
    medium, whose channel slabs are lerped at scaled and scrolled
    coordinates before the sweep (the fraction is not 0, so the lerp rounds
    once more). chunk reaches the block; use_kernels=True where no kernel
    covers the configuration raises NotImplementedError."""
    grid, scroll = _grid(combine, seed=3), _scroll(combine)
    _, tcfg, _, tmed, _, tplan = _case(combine, emission, eye)
    sc = None if scroll is None else torch.from_numpy(scroll)
    g0 = torch.from_numpy(grid.copy()).requires_grad_()
    want = tsweep.sweep_render(g0, tplan, tcfg, tmed, scroll=sc,
                               use_kernels=False)
    (want[..., :3] ** 2).sum().backward()
    with _one_rank_mesh(tmp_path) as mesh:
        g = torch.from_numpy(grid.copy()).requires_grad_()
        calls = tsweep.general_calls
        got = sweep_render_sharded(g, tplan, mesh, tcfg, tmed, scroll=sc,
                                   chunk=3, use_kernels=False)
        assert tsweep.general_calls - calls == 1
        (got[..., :3] ** 2).sum().backward()
        if combine == "single":
            assert torch.equal(got, want.detach())
            assert torch.equal(g.grad, g0.grad)
        else:
            scale = float(g0.grad.abs().max())
            torch.testing.assert_close(got, want.detach(), rtol=1e-6,
                                       atol=1e-6)
            torch.testing.assert_close(g.grad, g0.grad, rtol=1e-6,
                                       atol=1e-6 * scale)
            _, tcfg, _, tmed, _, tplan = _case(combine, emission, eye,
                                               "clamp")
            with pytest.raises(NotImplementedError, match="no kernel"):
                sweep_render_sharded(torch.from_numpy(grid), tplan, mesh,
                                     tcfg, tmed, scroll=sc, use_kernels=True)


def test_early_exit_rate_matches_jax():
    """bench.early_exit_rate against bench.py's exit_rate expression (the
    JAX general sweep on the permuted grid times the density, the medium at
    density 1) at a density where the rate lies strictly between 0 and 1.
    The two sweeps' transmittances differ by float rounding, so only a
    pixel whose JAX transmittance lies within that difference of the
    threshold may be counted on the other side: the counts may differ by
    at most the number of such pixels."""
    density = 60.0
    grid = _grid("single", seed=4)
    jcfg, tcfg, jmed, tmed, jplan, tplan = _case("single", True, "default")
    med1 = dataclasses.replace(jmed, density=1.0)
    maps = jsweep._sweep_base(
        jnp.transpose(jnp.asarray(grid), jplan.perm) * density, None,
        jplan.slice_z, jplan.v_grid, jplan.u_grid, jplan.seglen, jplan, jcfg,
        med1, None, None)
    jtrans = np.asarray(maps[1])
    eps = jcfg.early_stop_transmittance
    want = int((jtrans <= eps).sum())
    rate = tbench.early_exit_rate(torch.from_numpy(grid), tplan, tcfg, tmed,
                                  density)
    assert 0.0 < rate < 1.0
    with torch.no_grad():
        ttrans = tsweep._sweep_base(
            torch.from_numpy(grid).permute(tplan.perm) * density, None,
            tplan.slice_z, tplan.v_grid, tplan.u_grid, tplan.seglen, tplan,
            tcfg, dataclasses.replace(tmed, density=1.0), None, None)[1]
    band = float(np.abs(ttrans.numpy() - jtrans).max())
    near = int((np.abs(jtrans - eps) <= band).sum())
    got = round(rate * jtrans.size)
    assert abs(got - want) <= near, (got, want, near, band)


def test_main_prints_the_line_on_the_cpu(monkeypatch, capsys):
    """main(["--device", "cpu"]) at 16^3 / 48x32: the last stdout line is
    the JSON line with every key, the sizes it ran, the gradient check
    passed, no kernel launch on the CPU (the plain versions run), the
    general sweep only on its A/B (3 timed + 1 warm-up) and the two exit
    rates."""
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    assert tbench.main(["--device", "cpu", "--runs", "2", "--warmup",
                        "1"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(LINE_KEYS) <= set(line)
    assert line["metric"] == "rays/s/chip fwd+bwd at 256^3/1080p"
    assert (line["volume"], line["image"]) == (16, [48, 32])
    assert line["grad_allclose_vs_reference"] is True
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert (line["timed_runs"], line["warmup_runs"]) == (2, 1)
    zero = {"sweep_fwd": 0, "sweep_bwd": 0}
    assert line["launches_per_step"] == {"fwd_bwd": zero, "bf16": zero}
    assert line["general_sweep_calls"] == {"fwd_bwd": 0, "bf16": 0,
                                           "general": 4, "exit_rate": 2}
    assert math.isfinite(line["value"]) and line["value"] > 0.0
    assert line["vs_baseline"] == line["value"] / (1280 * 720 * 60.0)
    assert 0.0 <= line["early_exit_rate_flagship"] <= \
        line["early_exit_rate_dense"] < 1.0
    assert "grad check: allclose=True" in out.err


def test_default_device_fails_without_a_gpu(monkeypatch, capsys):
    """--device defaults to cuda: with no GPU the command fails with
    torch's own error and prints no line, as the CLI does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    with pytest.raises((RuntimeError, AssertionError)):
        tbench.main(["--runs", "1", "--warmup", "0"])
    assert capsys.readouterr().out == ""
