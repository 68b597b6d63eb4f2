"""fit_grid's optimizer step: Adam's update and the clamp of the grid, as
one hand-written CUDA kernel (csrc/adam_clamp.cu) on a CUDA grid, and its
plain version (adam_clamp_reference) on any other.

The plain version is torch.optim.Adam's step followed by clamp_(lo, hi)
under no_grad: on the card, torch's foreach path, seven passes over the
grid-sized tensors and an eighth for the clamp. The kernel makes one pass,
in torch's order of operations and rounding (csrc/adam_clamp.cu), so both
leave the grid and the moments alike.

adam_clamp_step keeps the Adam state where and as torch.optim.Adam keeps
it, in optimizer.state[grid]: "step" a float32 CPU scalar tensor, counted
up before the bias corrections; "exp_avg" and "exp_avg_sq" zeros_like(grid)
at the first step. So utils/checkpoint.py's leaves, a resume, and a switch
between the two paths see one state. The optimizer's step hooks (torch's
global ones and its own, pre and post) run around the kernel's step as
they run around optimizer.step().

`launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from itertools import chain

import numpy as np
import torch
from torch.optim.optimizer import (_global_optimizer_post_hooks,
                                   _global_optimizer_pre_hooks)

from .build import build_library

__all__ = ["adam_clamp_step", "adam_clamp_reference", "host_scalars",
           "check_inputs", "build_kernel", "launch_kernel", "launches"]

# kernel launches since import (or since a caller reset them)
launches = 0

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output


def adam_clamp_reference(optimizer, grid, lo, hi):
    """The plain version: optimizer.step(), then grid.clamp_(lo, hi)."""
    optimizer.step()
    with torch.no_grad():
        grid.clamp_(lo, hi)


def host_scalars(group, step: float):
    """The kernel's scalars for Adam step `step` (counted from 1) of a
    parameter group, computed in double as torch's non-capturable
    _multi_tensor_adam computes them: (1 - beta1, beta2, 1 - beta2,
    step_size = -lr / (1 - beta1^step), bias_correction2_sqrt =
    sqrt(1 - beta2^step), eps)."""
    beta1, beta2 = (float(b) for b in group["betas"])
    lr = float(group["lr"])
    bias_correction1 = 1 - beta1 ** step
    bias_correction2 = 1 - beta2 ** step
    return (1 - beta1, beta2, 1 - beta2, (lr / bias_correction1) * -1,
            bias_correction2 ** 0.5, float(group["eps"]))


def _check_optimizer(optimizer, grid):
    """The optimizer must hold `grid` as its one parameter, in one group,
    with only the options the kernel implements (no weight decay, amsgrad
    or maximize)."""
    groups = optimizer.param_groups
    if len(groups) != 1 or len(groups[0]["params"]) != 1 \
            or groups[0]["params"][0] is not grid:
        raise ValueError("adam_clamp: the optimizer must hold the grid as "
                         "its one parameter")
    group = groups[0]
    if group.get("weight_decay", 0) != 0 or group.get("amsgrad") \
            or group.get("maximize"):
        raise ValueError("adam_clamp: weight_decay, amsgrad and maximize "
                         "are not supported")


def check_inputs(grid, grad, exp_avg=None, exp_avg_sq=None):
    """Check the tensors of a step before their pointers go to the kernel:
    float32, contiguous, one device and one numel; the moments may be None
    (not created yet)."""
    for name, t in (("grid", grid), ("grad", grad), ("exp_avg", exp_avg),
                    ("exp_avg_sq", exp_avg_sq)):
        if t is None:
            if name == "grad":
                raise ValueError("adam_clamp: the grid has no gradient")
            continue
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != grid.device or t.numel() != grid.numel():
            raise ValueError(
                f"adam_clamp: {name} must be a contiguous float32 tensor "
                f"of {grid.numel()} elements on {grid.device}; got "
                f"{t.dtype}, {t.numel()} elements on {t.device}, "
                f"contiguous={t.is_contiguous()}")


def build_kernel():
    """Build (at first use) and load the kernel's library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("adam_clamp")
        fn = lib.adam_clamp_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_int] \
            + [ctypes.c_float] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(grid, grad, exp_avg, exp_avg_sq, scalars, lo, hi):
    """Launch one step on the current stream, updating grid, exp_avg and
    exp_avg_sq in place, and count it; the tensors passed check_inputs.
    scalars: host_scalars' six. The float4 path when all four pointers are
    16-byte aligned, else the scalar path."""
    global launches
    dev = grid.device
    if dev.type != "cuda":
        raise ValueError(f"adam_clamp kernel: needs CUDA tensors, got {dev}")
    build_kernel()
    ptrs = [t.data_ptr() for t in (grid, grad, exp_avg, exp_avg_sq)]
    aligned = all(p % 16 == 0 for p in ptrs)
    with torch.cuda.device(dev):
        rc = _lib.adam_clamp_launch(
            *ptrs, grid.numel(), int(aligned), *scalars, lo, hi,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adam_clamp kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1


def _kernel_step(optimizer, grid, lo, hi):
    """adam_clamp_step on a CUDA grid, after its checks: the state made as
    torch makes it at the first step, one launch, the step counted. torch
    counts the float32 step up before the bias corrections; the count is
    taken first and stored after the launch, off the path to it."""
    state = optimizer.state[grid]
    if not state:
        state["step"] = torch.tensor(0.0, dtype=torch.float32)
        state["exp_avg"] = torch.zeros_like(
            grid, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(
            grid, memory_format=torch.preserve_format)
    step = state["step"]
    t = float(np.float32(step.item()) + np.float32(1.0))
    launch_kernel(grid, grid.grad, state["exp_avg"], state["exp_avg_sq"],
                  host_scalars(optimizer.param_groups[0], t), lo, hi)
    step += 1


def _step_with_hooks(optimizer, grid, lo, hi):
    """_kernel_step between the optimizer's step hooks, torch's global ones
    and its own, pre then post, in the order of
    torch.optim.Optimizer.profile_hook_step, which runs them around
    optimizer.step(). That wrapper also opens a profiler range, whose host
    time (about 50 us under the profiler and 10 to 60 us without, measured
    on an H100 machine) would fall inside the step: fit_grid's guard has
    left the stream idle, so the host's time to the launch is the
    device's too."""
    args, kwargs = (optimizer, grid, lo, hi), {}
    for hook in chain(_global_optimizer_pre_hooks.values(),
                      optimizer._optimizer_step_pre_hooks.values()):
        result = hook(optimizer, args, kwargs)
        if result is not None:
            args, kwargs = result
    _kernel_step(*args, **kwargs)
    for hook in chain(optimizer._optimizer_step_post_hooks.values(),
                      _global_optimizer_post_hooks.values()):
        hook(optimizer, args, kwargs)


def adam_clamp_step(optimizer, grid, lo, hi):
    """One Adam step of the optimizer's one parameter, `grid`, then the
    clamp of the grid to [lo, hi]: the kernel on a CUDA grid, which raises
    rather than fall back; the plain version on any other device. Both
    refuse the same inputs, before anything is changed, and both run the
    optimizer's step hooks."""
    _check_optimizer(optimizer, grid)
    state = optimizer.state[grid]
    check_inputs(grid, grid.grad, state.get("exp_avg"),
                 state.get("exp_avg_sq"))
    if grid.device.type != "cuda":
        return adam_clamp_reference(optimizer, grid, lo, hi)
    _step_with_hooks(optimizer, grid, lo, hi)
