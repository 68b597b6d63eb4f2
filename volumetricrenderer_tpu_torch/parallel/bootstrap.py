"""Multi-process bootstrap (port of
volumetricrenderer_tpu/parallel/bootstrap.py):
torch.distributed.init_process_group with a retried handshake.

Each process of a sharded run (parallel/sweep_sharded.py) calls
initialize_distributed() before it builds a mesh. The function is a no-op
for a single-process run unless configured, reads the names torch's
launcher (torchrun) sets, and retries the rendezvous: the process that
hosts the store may come up seconds after the rest.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.metrics import get_logger
from .mesh import BACKENDS

__all__ = ["initialize_distributed", "is_distributed", "process_summary"]

_initialized = False


def is_distributed() -> bool:
    """True when a process group of more than one process is running."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _init_process_group(coordinator_address, num_processes, process_id,
                        local_device_ids, device):
    """torch.distributed.init_process_group for `device`'s backend (NCCL
    for "cuda", gloo for "cpu") at tcp://coordinator_address, or from the
    environment (env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) when
    no address is given. On "cuda", selects the device local_device_ids
    names (LOCAL_RANK's)."""
    if device == "cuda" and local_device_ids is not None:
        torch.cuda.set_device(int(local_device_ids))
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group(BACKENDS[device], **kw)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    retries: int = 5,
    retry_delay_s: float = 5.0,
    device: str = "cuda",
    _initialize_fn=None,
) -> bool:
    """Start the process group. Returns True if one was started (or already
    was), False for the single-process no-op.

    The arguments default to the names torch's launcher sets:
    coordinator_address to MASTER_ADDR:MASTER_PORT, num_processes to
    WORLD_SIZE, process_id to RANK, local_device_ids to LOCAL_RANK (the
    CUDA device this process drives). With none of them set, set
    VOLT_DISTRIBUTED=1 to opt in anyway (the group then initializes from
    the environment, env://). Without the opt-in, an unconfigured
    environment, or one of a single process, is a single-process run and
    nothing is started. The backend follows `device`: NCCL for "cuda",
    gloo for "cpu".

    The handshake is tried `retries` times, `retry_delay_s` apart; after
    the last failure a RuntimeError is raised from it.

    _initialize_fn: test seam, called with coordinator_address,
    num_processes, process_id and local_device_ids in place of the
    process group's initialization."""
    global _initialized
    log = get_logger()
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = env["MASTER_ADDR"]
        if env.get("MASTER_PORT"):
            coordinator_address += ":" + env["MASTER_PORT"]
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if local_device_ids is None and env.get("LOCAL_RANK"):
        local_device_ids = int(env["LOCAL_RANK"])

    autodetect = (coordinator_address is None and num_processes is None
                  and env.get("VOLT_DISTRIBUTED") == "1")
    if (coordinator_address is None and num_processes in (None, 1)
            and not autodetect):
        log.info("distributed: single-process run (no coordinator "
                 "configured and VOLT_DISTRIBUTED unset); skipping "
                 "torch.distributed.init_process_group")
        return False
    if _initialized:
        return True

    if _initialize_fn is None:
        def _initialize_fn(**kw):
            _init_process_group(device=device, **kw)
    last_err = None
    for attempt in range(max(retries, 1)):
        try:
            _initialize_fn(coordinator_address=coordinator_address,
                           num_processes=num_processes,
                           process_id=process_id,
                           local_device_ids=local_device_ids)
            _initialized = True
            log.info("distributed: initialized process %s/%s via %s",
                     process_id, num_processes, coordinator_address)
            return True
        except Exception as e:  # the store not up yet, a transient refusal
            last_err = e
            log.warning("distributed: initialize attempt %d/%d failed: %s",
                        attempt + 1, retries, e)
            if attempt + 1 < retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(
        f"torch.distributed initialization failed after {retries} attempts"
    ) from last_err


def process_summary() -> dict:
    """This process's place in the run, for logs and metrics:
    process_index (the rank), process_count (the world size),
    local_devices (the CUDA devices this host's process sees, 1 on the
    CPU), global_devices (one per process) and backend (the process
    group's, else "cuda" or "cpu", the platform)."""
    running = dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "process_index": dist.get_rank() if running else 0,
        "process_count": dist.get_world_size() if running else 1,
        "local_devices": torch.cuda.device_count() if cuda else 1,
        "global_devices": dist.get_world_size() if running else 1,
        "backend": (dist.get_backend() if running
                    else "cuda" if cuda else "cpu"),
    }
