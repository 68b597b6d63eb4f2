"""Nothing under benchmark/ imports JAX or the JAX package, the top-level
name compared whole (the port's name begins with the JAX package's); the
reference and the yardstick import nothing of the program; a run refuses
to print a result where such a module is loaded."""
import ast
import pathlib
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = pathlib.Path(harness.BENCH)
JAX = {"jax", "jaxlib", "flax", "volumetricrenderer_tpu"}
PORT = "volumetricrenderer_tpu_torch"
# The yardstick: what decides `correct` and counts the work.
YARDSTICK = ("reference.py", "plan.py", "scene.py", "roofline.py",
             "traffic.py", "profiling.py")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_nothing_imports_jax():
    sources = sorted(BENCH.rglob("*.py"))
    assert len(sources) > 20
    for path in sources:
        bad = set(_imports(path)) & JAX
        assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


def test_whole_name_compared():
    assert "volumetricrenderer_tpu_torch" not in JAX
    assert PORT.split(".")[0] != "volumetricrenderer_tpu"


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert PORT not in set(_imports(BENCH / name))


def test_reference_runs_with_the_program_blocked():
    script = (
        "import sys\n"
        f"sys.modules[{PORT!r}] = None\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r})\n"
        "import torch\n"
        "from benchmark import plan, reference, roofline, scene, traffic\n"
        "g = scene.make_grid({'kind': 'cloud', 'size': 8}, 3, 'cpu')\n"
        "cam = {'eye': [3, 3, 3], 'center': [0, 0, 0], 'up': [0, 0, 1],\n"
        "       'fov_y_degrees': 45.0, 'width': 16, 'height': 12}\n"
        "p = plan.make_plan(cam, g.shape, 'cpu')\n"
        "med = {'density': 8.0, 'sample_scale': 0.2,\n"
        "       'early_stop_transmittance': 1e-3, 'ambient': 0.1,\n"
        "       'light_color': [1, 1, 1], 'background': [0, 0, 0],\n"
        "       'light_direction': [0.5, 0.5, 1.0]}\n"
        "lv = reference.light_volume(g, med)\n"
        "print(reference.render(g, p, med, lv).shape)\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "torch.Size([12, 16, 4])" in out.stdout


def test_forbidden_module_is_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "volumetricrenderer_tpu.ops", object())
    assert harness.forbidden_modules() == ["volumetricrenderer_tpu"]


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "config3.view",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
