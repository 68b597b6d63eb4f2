"""frame_ab.py, the A/B of whole frames against another copy of the port,
rehearsed on the CPU at 16^3 / 48x32 (--small): the measuring turn on the
package it is given, and the turns in processes of their own, one line
each, written to --out. No JAX: the script imports only the port."""
import json
import pathlib

import torch

import frame_ab
import volumetricrenderer_tpu_torch as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES = ("config4_frame", "config4_frame_plan0", "light_sweep",
          "render_given_lv", "render_unshadowed", "config4_frame_no_grad",
          "reference_frame_emission_True", "reference_frame_emission_False")

torch.set_num_threads(1)


def test_measure_runs_every_frame_on_the_cpu():
    """On the CPU each frame runs once and times nothing (None)."""
    res = frame_ab.measure(T, "this", "cpu", small=True)
    assert res["label"] == "this"
    assert res["package"] == str(ROOT / "volumetricrenderer_tpu_torch")
    assert all(res[k] is None for k in FRAMES)
    assert res["plan_s_per_plan"] > 0.0


def test_turns_run_in_processes_of_their_own(tmp_path, capsys):
    """One round: the other tree (here this one again), then this one, a
    process each; both lines printed and written to --out."""
    assert frame_ab.main(["--other", str(ROOT), "--rounds", "1", "--device",
                          "cpu", "--small", "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    written = (tmp_path / "frame_ab.jsonl").read_text().strip().splitlines()
    assert printed == written and len(written) == 2
    lines = [json.loads(x) for x in written]
    assert [x["label"] for x in lines] == ["other", "this"]
    for x in lines:
        assert set(FRAMES) <= set(x)
        assert x["package"] == str(ROOT / "volumetricrenderer_tpu_torch")
