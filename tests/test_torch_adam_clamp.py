"""fit_grid's optimizer step (kernels/adam_clamp.py) on the CPU: the wrapper
is the plain version there, torch.optim.Adam's step and clamp_, bit for
bit; the host scalars the kernel gets are the ones torch's foreach Adam
uses; the kernel's path runs the optimizer's step hooks as
optimizer.step() does; the wrapper and the launcher refuse what the kernel
cannot take. The kernel itself runs only on the card
(tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu_torch.kernels import adam_clamp
from volumetricrenderer_tpu_torch.utils import checkpoint as tckpt

SHAPE, LR, STEPS = (5, 6, 7), 5e-2, 5


def _grads(seed, n=STEPS):
    """Seeded gradients spanning several decades, so that some voxels move
    by about lr and the clamp acts."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=SHAPE)
                              * np.exp(rng.normal(-4.0, 3.0, SHAPE)))
                             .astype(np.float32)) for _ in range(n)]


def _param(seed=0):
    rng = np.random.default_rng(seed)
    return torch.nn.Parameter(torch.from_numpy(
        rng.uniform(0.0, 1.0, SHAPE).astype(np.float32)))


@pytest.mark.parametrize("start", ["fresh", "resumed"])
def test_cpu_wrapper_is_the_plain_version(start):
    """Five steps of adam_clamp_step on a CPU grid against five of
    torch.optim.Adam's step and clamp_, from a fresh state or from one
    restored from optax leaves (adam_state_from_leaves): grid, step and
    moments equal bit for bit."""
    p_got, p_want = _param(), _param()
    opt_got = torch.optim.Adam([p_got], lr=LR)
    opt_want = torch.optim.Adam([p_want], lr=LR)
    if start == "resumed":
        rng = np.random.default_rng(1)
        leaves = [np.asarray(7, np.int32),
                  rng.normal(0.0, 1e-2, SHAPE).astype(np.float32),
                  rng.uniform(0.0, 1e-3, SHAPE).astype(np.float32)]
        opt_got.state[p_got] = tckpt.adam_state_from_leaves(leaves, p_got)
        opt_want.state[p_want] = tckpt.adam_state_from_leaves(leaves, p_want)
    before = adam_clamp.launches
    for g in _grads(2):
        p_got.grad, p_want.grad = g.clone(), g.clone()
        adam_clamp.adam_clamp_step(opt_got, p_got, 0.0, 1.0)
        opt_want.step()
        with torch.no_grad():
            p_want.clamp_(0.0, 1.0)
    assert adam_clamp.launches == before
    assert torch.equal(p_got.detach(), p_want.detach())
    assert bool(((p_got == 0.0) | (p_got == 1.0)).any())  # the clamp acted
    got, want = opt_got.state[p_got], opt_want.state[p_want]
    assert float(got["step"]) == float(want["step"]) \
        == STEPS + (7 if start == "resumed" else 0)
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(tckpt.adam_state_to_leaves(opt_got, p_got),
                    tckpt.adam_state_to_leaves(opt_want, p_want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("step", [1, 2, 10, 1000])
def test_host_scalars_match_torch(step, monkeypatch):
    """host_scalars equals the scalars torch's foreach Adam passes its
    kernels at that step: the lerp's weight, the mul's beta2, the
    addcmul's value, the div's bias_correction2_sqrt, the add's eps and
    the addcdiv's step_size."""
    calls = {}

    def spy(name, real):
        def call(*args, **kw):
            calls.setdefault(name, []).append(args[1:])
            return real(*args, **kw)
        return call

    for name in ("_foreach_lerp_", "_foreach_mul_", "_foreach_addcmul_",
                 "_foreach_div_", "_foreach_add_", "_foreach_addcdiv_"):
        monkeypatch.setattr(torch, name, spy(name, getattr(torch, name)))
    p = _param()
    opt = torch.optim.Adam([p], lr=LR, foreach=True)
    opt.state[p] = tckpt.adam_state_from_leaves(
        [np.asarray(step - 1, np.int32), np.zeros(SHAPE, np.float32),
         np.zeros(SHAPE, np.float32)], p)
    p.grad = _grads(3, 1)[0]
    opt.step()
    assert float(opt.state[p]["step"]) == step
    eps = [a[0] for a in calls["_foreach_add_"] if isinstance(a[0], float)]
    want = (calls["_foreach_lerp_"][0][1], calls["_foreach_mul_"][0][0],
            calls["_foreach_addcmul_"][0][2],
            calls["_foreach_addcdiv_"][0][2][0],
            calls["_foreach_div_"][0][0][0], eps[0])
    got = adam_clamp.host_scalars(opt.param_groups[0], float(step))
    assert got == want


def test_kernel_path_runs_the_step_hooks_in_torchs_order(monkeypatch):
    """The hooks around the kernel's step (_step_with_hooks) are those
    optimizer.step() runs, in its order, each given the optimizer: torch's
    global pre hooks, the optimizer's own, the step, its own post hooks,
    the global ones. The benchmark's traced fit finds the grid through a
    global post hook."""
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)
    p = _param()
    p.grad = _grads(4, 1)[0]
    opt = torch.optim.Adam([p], lr=LR)
    order = []

    def hook(name):
        return lambda o, args, kwargs: order.append((name, o))

    handles = [register_optimizer_step_pre_hook(hook("global pre")),
               register_optimizer_step_post_hook(hook("global post")),
               opt.register_step_pre_hook(hook("own pre")),
               opt.register_step_post_hook(hook("own post"))]
    try:
        opt.step()
        want = [name for name, _ in order]
        order.clear()
        monkeypatch.setattr(adam_clamp, "_kernel_step",
                            lambda o, *a: order.append(("step", o)))
        adam_clamp._step_with_hooks(opt, p, 0.0, 1.0)
    finally:
        for h in handles:
            h.remove()
    assert want == ["global pre", "own pre", "own post", "global post"]
    assert [name for name, _ in order] == want[:2] + ["step"] + want[2:]
    assert all(o is opt for _, o in order)


def _bad_case(kind):
    """An optimizer, grid and state that the wrapper must refuse."""
    p = _param()
    opt = torch.optim.Adam([p], lr=LR)
    p.grad = torch.zeros(SHAPE)
    if kind == "float64 grid":
        p = torch.nn.Parameter(p.detach().double())
        opt = torch.optim.Adam([p], lr=LR)
        p.grad = torch.zeros(SHAPE, dtype=torch.float64)
    elif kind == "non-contiguous moment":
        opt.state[p] = {"step": torch.tensor(1.0),
                        "exp_avg": torch.zeros(SHAPE[::-1]).permute(2, 1, 0),
                        "exp_avg_sq": torch.zeros(SHAPE)}
    elif kind == "mismatched numel":
        opt.state[p] = {"step": torch.tensor(1.0),
                        "exp_avg": torch.zeros(SHAPE),
                        "exp_avg_sq": torch.zeros(SHAPE[:2] + (8,))}
    elif kind == "no gradient":
        p.grad = None
    elif kind == "another parameter":
        opt = torch.optim.Adam([p, torch.nn.Parameter(torch.zeros(3))],
                               lr=LR)
    elif kind == "weight decay":
        opt = torch.optim.Adam([p], lr=LR, weight_decay=1e-4)
    return opt, p


@pytest.mark.parametrize("kind", ["float64 grid", "non-contiguous moment",
                                  "mismatched numel", "no gradient",
                                  "another parameter", "weight decay"])
def test_wrapper_refuses_what_the_kernel_cannot_take(kind):
    opt, p = _bad_case(kind)
    grid_before = p.detach().clone()
    with pytest.raises(ValueError, match="adam_clamp"):
        adam_clamp.adam_clamp_step(opt, p, 0.0, 1.0)
    assert torch.equal(p.detach(), grid_before)


def test_kernel_launch_refuses_cpu_tensors():
    p = torch.rand(SHAPE)
    before = adam_clamp.launches
    with pytest.raises(ValueError, match="CUDA"):
        adam_clamp.launch_kernel(p, torch.rand(SHAPE), torch.zeros(SHAPE),
                                 torch.zeros(SHAPE),
                                 adam_clamp.host_scalars(
                                     {"betas": (0.9, 0.999), "lr": LR,
                                      "eps": 1e-8}, 1.0), 0.0, 1.0)
    assert adam_clamp.launches == before
