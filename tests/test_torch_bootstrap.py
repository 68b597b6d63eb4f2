"""The port's parallel/bootstrap.py against tests/test_bootstrap.py's six
cases for the JAX package: the single-process no-op, the retried
handshake, the failure after the last retry, configuration from the
environment (torch's launcher's names), the process summary and the
VOLT_DISTRIBUTED opt-in; and make_mesh's checks."""
import pytest
import torch.distributed as dist

from volumetricrenderer_tpu_torch.parallel import bootstrap
from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setattr(bootstrap, "_initialized", False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "VOLT_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)


def test_single_process_noop():
    calls = []
    started = bootstrap.initialize_distributed(
        _initialize_fn=lambda **kw: calls.append(kw))
    assert started is False and calls == []
    assert not bootstrap.is_distributed()


def test_retry_until_coordinator_up():
    attempts = []

    def flaky(**kw):
        attempts.append(kw)
        if len(attempts) < 3:
            raise ConnectionError("coordinator not up")

    started = bootstrap.initialize_distributed(
        coordinator_address="host0:1234", num_processes=2, process_id=1,
        retries=5, retry_delay_s=0.0, _initialize_fn=flaky)
    assert started is True
    assert len(attempts) == 3
    assert attempts[0]["coordinator_address"] == "host0:1234"
    assert attempts[0]["num_processes"] == 2
    assert attempts[0]["process_id"] == 1


def test_gives_up_after_retries():
    def always_down(**kw):
        raise ConnectionError("nope")

    with pytest.raises(RuntimeError, match="after 2 attempts"):
        bootstrap.initialize_distributed(
            coordinator_address="host0:1234", num_processes=2,
            process_id=1, retries=2, retry_delay_s=0.0,
            _initialize_fn=always_down)


def test_env_var_configuration(monkeypatch):
    """torchrun's names: MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK and
    LOCAL_RANK (the device)."""
    monkeypatch.setenv("MASTER_ADDR", "envhost")
    monkeypatch.setenv("MASTER_PORT", "9")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    seen = {}

    def ok(**kw):
        seen.update(kw)

    assert bootstrap.initialize_distributed(_initialize_fn=ok,
                                            retries=1) is True
    assert seen["coordinator_address"] == "envhost:9"
    assert seen["num_processes"] == 4 and seen["process_id"] == 2
    assert seen["local_device_ids"] == 1


def test_process_summary_keys():
    s = bootstrap.process_summary()
    assert set(s) == {"process_index", "process_count", "local_devices",
                      "global_devices", "backend"}
    assert s["process_index"] == 0 and s["process_count"] == 1
    assert s["global_devices"] == 1
    assert s["backend"] == "cpu" and s["local_devices"] == 1


def test_volt_distributed_opt_in(monkeypatch):
    """VOLT_DISTRIBUTED=1 with nothing configured still initializes, with
    no explicit configuration (the group reads env:// itself)."""
    monkeypatch.setenv("VOLT_DISTRIBUTED", "1")
    seen = {}

    def ok(**kw):
        seen.update(kw)

    assert bootstrap.initialize_distributed(_initialize_fn=ok,
                                            retries=1) is True
    assert seen["coordinator_address"] is None
    assert seen["num_processes"] is None and seen["process_id"] is None


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="device"):
        make_mesh(1, 1, device="tpu")


def test_make_mesh_checks_the_shape_and_the_backend(tmp_path):
    """A one-process gloo group: a (1, 1) CPU mesh; a CUDA mesh needs
    NCCL; a shape that is not the world size is refused."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "slab")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="nccl"):
            make_mesh(device="cuda")
        with pytest.raises(ValueError, match="2x1"):
            make_mesh(2, 1, device="cpu")
        assert bootstrap.process_summary()["backend"] == "gloo"
    finally:
        dist.destroy_process_group()
