"""The PyTorch port never imports JAX (nor optax): every module imports,
a frame renders and a fit steps, checkpoints and resumes, in a process
where `import jax` and `import optax` fail."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "volumetricrenderer_tpu_torch"


def _port_sources():
    # _build/ holds build outputs, not sources
    return sorted(p for p in PKG.rglob("*.py")
                  if "_build" not in p.relative_to(PKG).parts) \
        + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax():
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
        grid = T.cloud_volume(16, 7)
        cam = T.make_camera(T.CameraConfig(width=48, height=32))
        img = T.render_image(grid, cam,
                             T.RenderConfig(emission=True,
                                            quadrature="sliced"),
                             T.MediumConfig(combine="single", density=8.0))
        assert img.shape == (32, 48, 4) and bool(torch.isfinite(img).all())
        import tempfile
        from volumetricrenderer_tpu_torch import cli
        from volumetricrenderer_tpu_torch.utils import checkpoint
        out = tempfile.mkdtemp()
        args = ["fit", "--size", "8", "--image-size", "16", "--steps", "2",
                "--out-dir", out]
        assert cli.main(args) == 0 and cli.main(args + ["--resume"]) == 0
        assert checkpoint.latest_step(out + "/ckpt") == 2
        assert not any(k in ("jax", "optax")
                       or k.startswith(("jax.", "jaxlib", "optax."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
