"""The screen warp's kernel pair (kernels/warp_bilinear.py) on the CPU:
which calls take the kernel and which its plain version (a CPU base the
plain version, any other the kernel or a refusal), the launcher's input
checks, and the plain version with the miss
folded into the op against the op without it and a torch.where after it,
bit for bit. The kernels themselves run only on the card
(tests/test_torch_gpu.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from volumetricrenderer_tpu_torch import CameraConfig, RenderConfig, \
    make_camera
from volumetricrenderer_tpu_torch.kernels import warp_bilinear
from volumetricrenderer_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)


def _plan():
    return tsweep.plan_sweep(
        make_camera(CameraConfig(eye=(2.2, 2.8, 2.4), width=40, height=24)),
        (10, 10, 10), RenderConfig(emission=True, quadrature="sliced"))


def _base(plan, channels=2, dtype=torch.float32, seed=3):
    return torch.tensor(np.random.default_rng(seed).random(
        plan.base_shape + (channels,)), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_base_takes_the_plain_version(dtype):
    """On a CPU base the op is its plain version, in float32 and float64:
    forward and base gradient equal warp_reference and splat_reference bit
    for bit, and no kernel is launched."""
    plan = _plan()
    rows, cols = plan.warp_rows01.to(dtype), plan.warp_cols01.to(dtype)
    plan = dataclasses.replace(plan, warp_rows01=rows, warp_cols01=cols)
    base = _base(plan, dtype=dtype).requires_grad_()
    ct = torch.ones(tuple(rows.shape) + (2,), dtype=dtype)
    before = dict(warp_bilinear.launches)
    got = tsweep.warp_base_to_pixels(base, plan, miss=(0.0, 1.0))
    got.backward(ct)
    want = warp_bilinear.warp_reference(
        base.detach(), rows, cols, torch.tensor((0.0, 1.0), dtype=dtype))
    assert torch.equal(got, want)
    assert torch.equal(base.grad, warp_bilinear.splat_reference(
        ct, rows, cols, tuple(base.shape), True))
    assert warp_bilinear.launches == before


@pytest.mark.parametrize("case,match", [
    ("float64 base", "base must be float32"),
    ("bfloat16 base", "base must be float32"),
    ("float64 maps", "rows01 must be float32"),
    ("five channels", "1 <= C <= 4"),
    ("float32", "needs CUDA tensors")])
def test_warp_off_the_cpu_is_the_kernel_or_refused(case, match):
    """Off the CPU the op takes the kernel, never its plain version: what
    the kernel cannot take (a base or maps not float32, more than 4
    channels) is refused with a ValueError before anything is built or
    counted, here on the meta device, where even a float32 warp is refused
    for want of CUDA."""
    plan = _plan()
    base, rows, cols = _base(plan), plan.warp_rows01, plan.warp_cols01
    miss = (0.0, 1.0)
    if case == "float64 base":
        base = base.double()
    elif case == "bfloat16 base":
        base = base.bfloat16()
    elif case == "float64 maps":
        rows, cols = rows.double(), cols.double()
    elif case == "five channels":
        base, miss = _base(plan, 5), (0.0,) * 5
    plan = dataclasses.replace(plan, warp_rows01=rows.to("meta"),
                               warp_cols01=cols.to("meta"))
    before = dict(warp_bilinear.launches)
    with pytest.raises(ValueError, match=match):
        tsweep.warp_base_to_pixels(base.to("meta"), plan, miss=miss)
    assert warp_bilinear.launches == before


@pytest.mark.parametrize("channels,miss", [(1, 0.5), (2, (0.0, 1.0)),
                                           (4, (0.0, 0.0, 0.0, 1.0))])
def test_cpu_warp_launches_nothing_and_folds_the_miss(channels, miss):
    """On the CPU the op takes its plain version (no launch, splat_pixels
    untouched), and the miss folded into it equals the op without a miss
    followed by torch.where on the footprint, forward and base gradient
    bit for bit: the select's backward zeroes the out-of-footprint
    cotangents the folded splat masks."""
    plan = _plan()
    base = _base(plan, channels)
    ct = torch.tensor(np.random.default_rng(7).normal(
        size=tuple(plan.warp_rows01.shape) + (channels,)),
        dtype=torch.float32)
    rows, cols = plan.warp_rows01, plan.warp_cols01
    inr = (tsweep._in01(rows) & tsweep._in01(cols))[..., None]
    assert inr.any() and not inr.all()
    before = (dict(warp_bilinear.launches), warp_bilinear.splat_pixels())
    b1 = base.clone().requires_grad_()
    b2 = base.clone().requires_grad_()
    got = tsweep.warp_base_to_pixels(b1, plan, miss=miss)
    vals = torch.tensor(miss if isinstance(miss, tuple) else (miss,))
    want = torch.where(inr, tsweep._WarpBilinear.apply(b2, rows, cols, None),
                       vals)
    assert torch.equal(got, want)
    got.backward(ct)
    want.backward(ct)
    assert torch.equal(b1.grad, b2.grad) and float(b1.grad.abs().max()) > 0
    assert (dict(warp_bilinear.launches), warp_bilinear.splat_pixels()) \
        == before


def test_non_contiguous_maps_are_taken():
    """Maps that are not contiguous (a transposed plan's, or a strided
    band) are read, never refused, and give what their contiguous copies
    give."""
    plan = _plan()
    base = _base(plan)
    strided = dataclasses.replace(
        plan, warp_rows01=plan.warp_rows01.t().contiguous().t(),
        warp_cols01=plan.warp_cols01.t().contiguous().t())
    assert not strided.warp_rows01.is_contiguous()
    outs, grads = [], []
    for p in (plan, strided):
        b = base.clone().requires_grad_()
        out = tsweep.warp_base_to_pixels(b, p, miss=(0.0, 1.0))
        (out ** 2).sum().backward()
        outs.append(out)
        grads.append(b.grad)
    assert torch.equal(*outs) and torch.equal(*grads)


def test_miss_of_another_length_is_refused():
    plan = _plan()
    with pytest.raises(ValueError, match="miss holds 3 values"):
        tsweep.warp_base_to_pixels(_base(plan), plan, miss=(0.0, 1.0, 0.0))


def _bad_call(kind):
    """(base_shape, rows01, cols01, miss, ct) the checks must refuse."""
    rows = torch.rand(6, 8)
    cols = torch.rand(6, 8)
    shape, miss, ct = (5, 7, 2), (0.0, 1.0), torch.rand(6, 8, 2)
    if kind == "two-dim base":
        shape = (5, 7)
    elif kind == "five channels":
        shape = (5, 7, 5)
    elif kind == "empty base":
        shape = (0, 7, 2)
    elif kind == "float64 rows":
        rows = rows.double()
    elif kind == "maps of two shapes":
        cols = torch.rand(6, 9)
    elif kind == "miss of one value":
        miss = (0.0,)
    elif kind == "ct of another shape":
        ct = torch.rand(6, 8, 3)
    elif kind == "float64 ct":
        ct = ct.double()
    return shape, rows, cols, miss, ct


@pytest.mark.parametrize("kind", ["two-dim base", "five channels",
                                  "empty base", "float64 rows",
                                  "maps of two shapes", "miss of one value",
                                  "ct of another shape", "float64 ct"])
def test_checks_refuse_what_the_kernel_cannot_take(kind):
    with pytest.raises(ValueError, match="warp_bilinear"):
        warp_bilinear.check_inputs(*_bad_call(kind))


def test_good_call_passes_the_checks():
    warp_bilinear.check_inputs(*_bad_call("none"))


@pytest.mark.parametrize("way", ["forward", "backward"])
def test_kernel_launch_refuses_cpu_tensors(way):
    """The launchers raise on CPU tensors before they build or count
    anything."""
    shape, rows, cols, miss, ct = _bad_call("none")
    before = dict(warp_bilinear.launches)
    with pytest.raises(ValueError, match="CUDA"):
        if way == "forward":
            warp_bilinear.launch_forward(torch.rand(shape), rows, cols, miss)
        else:
            warp_bilinear.launch_backward(ct, rows, cols, shape, True)
    assert warp_bilinear.launches == before
