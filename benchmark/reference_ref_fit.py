"""The plain reference of the reference configuration's fit: the first
steps of fitting the four noise channels of a (size,)^3 x 4 grid to a
target image, in plain PyTorch.

It imports nothing of the program. The render is reference_ref.py's
(sweep_maps, then finish), differentiated by autograd; the loss is
mean((rgb - target)^2) over the frame's three colour channels; the update
is Adam (lr, betas 0.9 and 0.999, eps 1e-8, bias-corrected, as optax.adam)
and then the clamp to [0, 1], written out as reference.fit_steps writes
them for one channel. The fit starts from the constant 0.1 grid in all
four channels, with no scroll.

Everything is float32 with TF32 off. tf32=True rounds every operand of
every matrix product to TF32 (reference.tf32_round, in the forward and in
both products of each backward): the control, the same computation one
precision below the configuration's. half_batch (a planted fault): the
loss is the mean over the top half of the rows only.
"""
from __future__ import annotations

import torch

from benchmark import reference_ref

CHANNELS = 4
INIT = 0.1


def render_rgb(grid, plan, med, tf32=False):
    """The (H, W, 3) colour of the frame, differentiable in the grid."""
    with reference_ref._no_tf32():
        acc, hit = reference_ref.sweep_maps(grid, plan, med, None, tf32)
        return reference_ref.finish(acc, hit, plan, med)[..., :3]


def fit_steps(target, plan, med, size, lr, steps, tf32=False,
              half_batch=False):
    """The fit's first `steps` steps from the constant 0.1 grid: (losses,
    the first gradient, the grid's change after the last step, the grid
    after the last step)."""
    dev = target.device
    grid = torch.full((size,) * 3 + (CHANNELS,), INIT, dtype=torch.float32,
                      device=dev)
    m = torch.zeros_like(grid)
    v = torch.zeros_like(grid)
    losses, g1 = [], None
    for t in range(1, steps + 1):
        g = grid.detach().requires_grad_(True)
        rgb = render_rgb(g, plan, med, tf32)
        if half_batch:
            h = rgb.shape[0] // 2
            loss = torch.mean((rgb[:h] - target[:h]) ** 2)
        else:
            loss = torch.mean((rgb - target) ** 2)
        grad, = torch.autograd.grad(loss, g)
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = grad.clone()
        with torch.no_grad():
            m.lerp_(grad, 0.1)
            v.mul_(0.999).addcmul_(grad, grad, value=0.001)
            bc1, bc2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
            denom = (v.sqrt() / bc2 ** 0.5).add_(1e-8)
            grid = torch.clamp(grid.addcdiv(m, denom, value=-lr / bc1),
                               0.0, 1.0)
    return losses, g1, grid - INIT, grid
