"""The PyTorch port never imports JAX (nor optax): every module imports,
a frame renders, a fit steps, checkpoints and resumes, and the runners'
launcher runs a sharded rank body in place, in a process where `import
jax` and `import optax` fail."""
import ast
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "volumetricrenderer_tpu_torch"


def _port_sources():
    # _build/ holds build outputs, not sources
    return sorted(p for p in PKG.rglob("*.py")
                  if "_build" not in p.relative_to(PKG).parts) \
        + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
           ROOT / "bench_torch.py", ROOT / "frame_ab.py"]


def test_sources_import_no_jax():
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"volumetricrenderer_tpu_torch/ops/lighting.py",
            "volumetricrenderer_tpu_torch/ops/media.py",
            "volumetricrenderer_tpu_torch/utils/clock.py",
            "volumetricrenderer_tpu_torch/utils/sanitize.py",
            "volumetricrenderer_tpu_torch/serve.py",
            "volumetricrenderer_tpu_torch/utils/video.py",
            "volumetricrenderer_tpu_torch/parallel/mesh.py",
            "volumetricrenderer_tpu_torch/parallel/bootstrap.py",
            "volumetricrenderer_tpu_torch/parallel/sweep_sharded.py",
            "volumetricrenderer_tpu_torch/parallel/render_sharded.py",
            "volumetricrenderer_tpu_torch/bench.py",
            "volumetricrenderer_tpu_torch/tools/__init__.py",
            "volumetricrenderer_tpu_torch/tools/fit_config3.py",
            "volumetricrenderer_tpu_torch/tools/anim_config4.py",
            "volumetricrenderer_tpu_torch/tools/scale512.py",
            "volumetricrenderer_tpu_torch/tools/serve_local.py",
            "volumetricrenderer_tpu_torch/tools/measure_warp.py",
            "volumetricrenderer_tpu_torch/tools/trace_flagship.py",
            "volumetricrenderer_tpu_torch/tools/multichip.py",
            "volumetricrenderer_tpu_torch/tools/sharded_step.py",
            "volumetricrenderer_tpu_torch/tools/scaling_rehearsal.py",
            "volumetricrenderer_tpu_torch/tools/profile_parts.py",
            "chip_smoke.py", "kernel_ab.py", "bench_torch.py",
            "frame_ab.py"} <= names
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "optax",
                                   "volumetricrenderer_tpu"), \
                    f"{path.relative_to(ROOT)} imports {n}"


def test_port_imports_and_renders_without_jax():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["optax"] = None
        import torch
        torch.set_num_threads(1)
        import volumetricrenderer_tpu_torch as T
        for m in pkgutil.walk_packages(T.__path__, T.__name__ + "."):
            importlib.import_module(m.name)
        grid = T.cloud_volume(16, 7, device="cpu")
        cam = T.make_camera(T.CameraConfig(width=48, height=32))
        img = T.render_image(grid, cam,
                             T.RenderConfig(emission=True,
                                            quadrature="sliced"),
                             T.MediumConfig(combine="single", density=8.0))
        assert img.shape == (32, 48, 4) and bool(torch.isfinite(img).all())
        grid4 = T.build_volume(T.VolumeConfig(size=8), device="cpu")
        img = T.render_image(grid4, cam, T.RenderConfig(quadrature="sliced"),
                             T.MediumConfig(),
                             scroll=T.reference_media_scroll(1.7))
        assert img.shape == (32, 48, 4) and bool(torch.isfinite(img).all())
        assert float(img[..., 3].max()) == 1.0
        # config 4's path: the light volume and the shadowed sweep
        shadows = T.LightConfig(shadow_steps=32)
        for g, med in ((grid, T.MediumConfig(combine="single", density=8.0)),
                       (grid4, T.MediumConfig())):
            cfg = T.RenderConfig(emission=True, quadrature="sliced")
            lvol = T.light_transmittance_volume(g, shadows, cfg, med)
            assert lvol.shape == g.shape[:3] and float(lvol.max()) == 1.0
            img = T.render_image(g, cam, cfg, med, shadows)
            assert img.shape == (32, 48, 4)
            assert bool(torch.isfinite(img).all())
        # the bfloat16 stream mode and the preset front end
        low = T.RenderConfig(emission=True, quadrature="sliced",
                             dtype="bfloat16")
        g = grid.clone().requires_grad_()
        img = T.render_image(g, cam, low,
                             T.MediumConfig(combine="single", density=8.0))
        (img[..., :3] ** 2).sum().backward()
        assert g.grad.dtype == torch.float32
        assert bool(torch.isfinite(g.grad).all())
        import dataclasses
        for name in ("config1", "config3", "reference"):
            p = T.get_preset(name)
            p = dataclasses.replace(
                p, volume=dataclasses.replace(p.volume, size=8),
                camera=dataclasses.replace(p.camera, width=12, height=8))
            img = T.render_preset(p, t=0.5, device="cpu")
            assert img.shape == (8, 12, 4)
            assert bool(torch.isfinite(img).all())
        import tempfile
        from volumetricrenderer_tpu_torch import cli
        from volumetricrenderer_tpu_torch.utils import checkpoint
        out = tempfile.mkdtemp()
        args = ["fit", "--size", "8", "--image-size", "16", "--steps", "2",
                "--out-dir", out, "--device", "cpu"]
        assert cli.main(args) == 0 and cli.main(args + ["--resume"]) == 0
        assert checkpoint.latest_step(out + "/ckpt") == 2
        assert cli.main(["render", "--preset", "config4", "--volume-size",
                         "8", "--width", "12", "--height", "8", "--out",
                         out + "/frame.png", "--device", "cpu",
                         "--check-nan"]) == 0
        assert cli.main(["info", "--device", "cpu"]) == 0
        # the viewer front end: animate with a video, and a served frame
        assert cli.main(["animate", "--preset", "config4", "--volume-size",
                         "8", "--width", "12", "--height", "8", "--frames",
                         "2", "--orbit", "--out-dir", out + "/anim",
                         "--video", "a.html", "--device", "cpu"]) == 0
        from volumetricrenderer_tpu_torch.serve import InteractiveRenderer
        p = T.get_preset("config2")
        p = dataclasses.replace(
            p, volume=dataclasses.replace(p.volume, size=8),
            camera=dataclasses.replace(p.camera, width=12, height=8))
        frame = InteractiveRenderer(p, probe=1, device="cpu").render_frame()
        assert frame.shape == (8, 12, 3) and frame.dtype.name == "uint8"
        # parallel/: a sharded frame and train step on a one-process gloo
        # mesh
        import torch.distributed as dist
        from volumetricrenderer_tpu_torch.parallel import sweep_sharded
        from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh
        dist.init_process_group("gloo", init_method="file://" + out + "/pg",
                                rank=0, world_size=1)
        cfg = T.RenderConfig(emission=True, quadrature="sliced")
        med = T.MediumConfig(combine="single", density=8.0)
        mesh = make_mesh(device="cpu")
        plan = T.plan_for(cam, grid.shape, cfg, device="cpu")
        img = sweep_sharded.sweep_render_sharded(grid, plan, mesh, cfg, med)
        assert torch.equal(img, T.render_image(grid, cam, cfg, med,
                                               plan=plan))
        step, _ = sweep_sharded.make_sweep_train_step(
            mesh, plan, cfg, med, torch.full_like(grid, 0.4))
        assert step(img[..., :3]) > 0.0
        dist.destroy_process_group()
        # the runners' launcher, in place under torchrun's names: the
        # sharded step's rank body and profile_parts's stages
        import os
        from volumetricrenderer_tpu_torch.tools import (
            profile_parts, sharded_step, spawn_ranks)
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=port)
        line = spawn_ranks(sharded_step.rank_body, 1, "cpu", dict(
            volume=8, width=12, height=8, iters=1, do512=False))
        assert line["fwd_max_abs_diff"] == 0.0
        stages = profile_parts.stages(grid, plan, cfg, med)
        assert all(fn() is not None for fn in stages.values())
        assert not any(k in ("jax", "optax")
                       or k.startswith(("jax.", "jaxlib", "optax."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    script = script.replace("MASTER_PORT=port", f"MASTER_PORT={port!r}")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
