"""Checkpoint and resume of a fit (port of
volumetricrenderer_tpu/utils/checkpoint.py), in the same on-disk layout, so
a checkpoint written by either package resumes in the other:

    <dir>/ckpt_<step:08d>.npz   grid, opt_leaf_0, opt_leaf_1, ...
    <dir>/ckpt_<step:08d>.json  {"step": step, "extra": {...}}

Both files are written through a temporary file and a rename. The
optimizer state is a list of leaves: where the JAX package flattens an
optax pytree, the port stores the same leaves. For optax.adam they are
(count, mu, nu); adam_state_to_leaves and adam_state_from_leaves map them
to and from torch.optim.Adam's (step, exp_avg, exp_avg_sq) of the one
parameter, the grid.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "adam_initial_leaves", "adam_state_to_leaves",
           "adam_state_from_leaves"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def adam_initial_leaves(shape) -> List[np.ndarray]:
    """optax.adam's initial state leaves for a parameter of `shape`:
    count 0 and zero moments (a template for restore_checkpoint)."""
    zeros = np.zeros(tuple(shape), np.float32)
    return [np.asarray(0, np.int32), zeros, zeros.copy()]


def adam_state_to_leaves(optimizer: torch.optim.Adam,
                         param: torch.Tensor) -> List[np.ndarray]:
    """optax.adam's state leaves (count int32 scalar, mu, nu) for `param`
    from a torch Adam optimizer; before the first step, the initial
    leaves."""
    st = optimizer.state.get(param, {})
    if not st:
        return adam_initial_leaves(param.shape)
    return [np.asarray(int(st["step"]), np.int32), _host(st["exp_avg"]),
            _host(st["exp_avg_sq"])]


def adam_state_from_leaves(leaves, param: torch.Tensor) -> Dict[str, Any]:
    """torch Adam's per-parameter state for `param` from optax.adam's
    state leaves (count, mu, nu): assign it to optimizer.state[param]."""
    count, mu, nu = leaves

    def like(x):
        return torch.as_tensor(_host(x), dtype=param.dtype,
                               device=param.device).reshape(param.shape)

    # torch keeps a non-capturable Adam's step as a float32 CPU scalar.
    return {"step": torch.tensor(float(_host(count)), dtype=torch.float32),
            "exp_avg": like(mu).clone(), "exp_avg_sq": like(nu).clone()}


def save_checkpoint(directory: str, step: int, grid, opt_state=None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the checkpoint of `step` under directory and return its .npz
    path. grid: tensor or array; opt_state: a list of optimizer-state
    leaves (adam_state_to_leaves) or None."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    arrays = {"grid": _host(grid)}
    if opt_state is not None:
        arrays.update({f"opt_leaf_{i}": _host(leaf)
                       for i, leaf in enumerate(opt_state)})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    meta = {"step": step, "extra": extra or {}}
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(mpath + ".tmp", mpath)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name[len("ckpt_"):-len(".npz")])
        for name in os.listdir(directory)
        if name.startswith("ckpt_") and name.endswith(".npz")
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       opt_state_template=None):
    """Restore (step, grid, opt_state, extra); step=None takes the latest.

    opt_state_template: a list of leaves giving the state's length (e.g.
    adam_state_to_leaves of a fresh optimizer); each leaf the checkpoint
    holds replaces the template's. None skips the optimizer state. grid
    and the leaves come back as numpy arrays."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        grid = data["grid"]
        opt_state = None
        if opt_state_template is not None:
            opt_state = [
                data[f"opt_leaf_{i}"] if f"opt_leaf_{i}" in data else leaf
                for i, leaf in enumerate(opt_state_template)
            ]
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    extra = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            extra = json.load(f).get("extra", {})
    return step, grid, opt_state, extra
