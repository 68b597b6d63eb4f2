"""The sharded runners' rank launcher (volumetricrenderer_tpu_torch/tools/
__init__.py spawn_ranks, world_size) on the CPU: on CUDA without enough
cards every runner fails before any process starts (the device-count
message, or torch's own error), a failing rank fails the launch instead of
hanging it, and under torchrun's names the launcher runs in place."""
import os
import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_sharded_ranks import fail_on_rank_1, pid
from volumetricrenderer_tpu_torch.parallel import bootstrap
from volumetricrenderer_tpu_torch.tools import (multichip, profile_parts,
                                                scaling_rehearsal,
                                                sharded_step, spawn_ranks,
                                                under_torchrun, world_size)

TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
            "MASTER_PORT")


@pytest.fixture(autouse=True)
def _no_torchrun(monkeypatch):
    for name in TORCHRUN:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def no_gpu(monkeypatch):
    """No CUDA device, and no process may be spawned."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")

    def refuse(*args, **kwargs):
        raise AssertionError("a rank was spawned")
    monkeypatch.setattr(mp, "spawn", refuse)


@pytest.mark.parametrize("runner", [multichip, sharded_step])
def test_ranks_above_the_cards_fail_before_any_spawn(runner, no_gpu, capsys,
                                                     tmp_path, monkeypatch):
    """--ranks 2 on CUDA with 0 cards: RuntimeError naming both counts,
    before any process starts, no line printed and no file written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError,
                       match="2 ranks need one CUDA device each: 0 visible"):
        runner.main(["--ranks", "2", "--out", str(tmp_path / "line.json")])
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("runner", [multichip, sharded_step,
                                    scaling_rehearsal, profile_parts])
def test_default_device_fails_without_a_gpu(runner, no_gpu, capsys,
                                            tmp_path, monkeypatch):
    """The default device is cuda: with no GPU each runner fails (the
    device-count message, or torch's own error from the CUDA runtime) and
    prints nothing; none falls back to gloo or to the CPU."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)) as info:
        runner.main([])
    if runner is not profile_parts:
        assert "0 visible" in str(info.value)
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []


def test_a_failing_rank_fails_the_launch(monkeypatch):
    """Rank 1 raises while rank 0 waits at a barrier: the launch raises
    (a command exits non-zero) with the first error of a rank (rank 1's,
    or rank 0's lost peer) instead of hanging, and ends the other rank."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises((mp.ProcessRaisedException,
                        mp.ProcessExitedException)):
        spawn_ranks(fail_on_rank_1, 2, "cpu")


def test_torchrun_runs_in_place(monkeypatch):
    """Under torchrun's names the launcher joins the group they describe in
    this process, spawns nothing, returns rank 0's result and leaves no
    group behind; --ranks must then equal WORLD_SIZE."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    for name, value in zip(TORCHRUN, ("0", "1", "0", "localhost", port)):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(mp, "spawn", None)
    assert under_torchrun()
    assert world_size(None, 8) == 1
    with pytest.raises(ValueError, match="WORLD_SIZE is 1"):
        world_size(2, 8)
    assert spawn_ranks(pid, 1, "cpu") == os.getpid()
    assert not dist.is_initialized() and not bootstrap._initialized


def test_world_size_defaults():
    assert not under_torchrun()
    assert world_size(None, 3) == 3 and world_size(2, 3) == 2
    with pytest.raises(ValueError, match="0 ranks"):
        spawn_ranks(pid, 0, "cpu")
