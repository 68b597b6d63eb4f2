"""The plain reference: the sliced emission-absorption render, its light
volume, its gradient and the fit's Adam steps, in plain PyTorch.

It imports nothing of the program. It follows the definitions the port's
plain versions state (volumetricrenderer_tpu_torch/kernels/sweep_fwd.py
sweep_fwd_reference, ops/lighting.py, ops/sweep.py finish_image, fit.py):

* per slice, front to back, the texel-center bilinear sample of the
  slice's layer at the base grid's taps, mirror addressing, as two banded
  matrix products Wa @ G @ Wb^T; samples outside the box or behind the eye
  are masked;
* alpha = live * (1 - exp(-density * sample_scale * sample * seglen)),
  live = (T > early-stop transmittance) before the slice;
  wsum += T * alpha * shade, T *= 1 - alpha; with a light volume shade =
  ambient + (1 - ambient) * clip(lT, 0, 1), lT its layer's bilinear sample
  at the same taps;
* the base maps (wsum, T) warped to the pixels by clip-then-tent bilinear
  taps; pixels off the base grid take (0, 1); rgb = wsum * light color +
  T * background, alpha = 1 - T;
* the light volume: optical depth swept from the light side, sheared by
  the light's slope each slice with zero weight outside the box;
* the fit: loss mean((rgb - target)^2), Adam (betas 0.9, 0.999, eps 1e-8,
  torch's bias correction), then a clamp to [0, 1].

Everything is float32 with TF32 off. tf32=True rounds every operand of
every matrix product to TF32 (10 mantissa bits, to nearest even), with
float32 sums: the control, the same computation one precision below the
configuration's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 16  # slices per checkpointed chunk of the differentiated sweep


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties to even), kept float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so the two products
    of its backward."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        ct = tf32_round(ct)
        return ct @ b.T, a.T @ ct


def _mm(a, b, tf32):
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def _mirror(idx, size):
    m = torch.remainder(idx, 2 * size)
    return torch.where(m >= size, 2 * size - 1 - m, m)


def _in01(x):
    return (x >= 0.0) & (x <= 1.0)


def _taps(u01, n):
    p = u01 * n - 0.5
    i0f = torch.floor(p)
    f = p - i0f
    i0 = i0f.to(torch.int64)
    return i0, f


def resample_matrix(u01, n):
    """(len(u01), n): linear taps at normalized positions, mirror mode."""
    i0, f = _taps(u01, n)
    cols = torch.arange(n, device=u01.device)[None, :]
    zero = torch.zeros((), device=u01.device)
    return (torch.where(cols == _mirror(i0, n)[:, None], (1.0 - f)[:, None],
                        zero)
            + torch.where(cols == _mirror(i0 + 1, n)[:, None], f[:, None],
                          zero))


def _vacuum_matrix(u01, n):
    """As resample_matrix, but a tap outside [0, n) weighs nothing and a
    row whose position leaves [0, 1] is zero (the light's shear)."""
    i0, f = _taps(u01, n)
    cols = torch.arange(n, device=u01.device)[None, :]
    zero = torch.zeros((), device=u01.device)
    w0 = (1.0 - f) * ((i0 >= 0) & (i0 < n)).float()
    w1 = f * ((i0 + 1 >= 0) & (i0 + 1 < n)).float()
    m = (torch.where(cols == torch.clamp(i0, 0, n - 1)[:, None], w0[:, None],
                     zero)
         + torch.where(cols == torch.clamp(i0 + 1, 0, n - 1)[:, None],
                       w1[:, None], zero))
    return m * _in01(u01).float()[:, None]


def _light_sample(layer, a01, b01):
    A, B = layer.shape
    a0, fa = _taps(a01, A)
    b0, fb = _taps(b01, B)
    r0 = layer.index_select(0, _mirror(a0, A))
    r1 = layer.index_select(0, _mirror(a0 + 1, A))
    c0, c1 = _mirror(b0, B), _mirror(b0 + 1, B)
    wa0, wa1 = (1.0 - fa)[:, None], fa[:, None]
    wb0, wb1 = (1.0 - fb)[None, :], fb[None, :]
    return (wa0 * (wb0 * r0.index_select(1, c0) + wb1 * r0.index_select(1, c1))
            + wa1 * (wb0 * r1.index_select(1, c0)
                     + wb1 * r1.index_select(1, c1)))


class Counts:
    """Work the sweep needs, tallied on the device: samples in the box, in
    front of the eye and on a line still live (T above the early-stop
    threshold), and the rows plus columns of a slice that hold one."""

    def __init__(self, device):
        self.samples = torch.zeros((), dtype=torch.int64, device=device)
        self.lines = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, work):
        self.samples += work.sum()
        self.lines += work.any(1).sum() + work.any(0).sum()

    def read(self):
        return int(self.samples), int(self.lines)


def sweep_maps(grid, plan, med, lvol=None, tf32=False, counts=None):
    """(T, wsum) base maps of a (D, H, W) grid under a plan (plan.py), with
    an optional light volume of the grid's shape. Differentiable in the
    grid (checkpointed in chunks of CHUNK slices)."""
    gperm = grid.permute(plan["perm"])
    lperm = None if lvol is None else lvol.permute(plan["perm"])
    S, A, B = gperm.shape
    flip = plan["sign"] < 0
    e_k, e_a, e_b = plan["eye01"][0], plan["eye01"][1], plan["eye01"][2]
    v, u, seglen = plan["v_grid"], plan["u_grid"], plan["seglen"]
    density, scale = med["density"], med["sample_scale"]
    thresh, ambient = med["early_stop_transmittance"], med["ambient"]

    def slices(s0, s1, trans, wsum):
        for s in range(s0, s1):
            k = S - 1 - s if flip else s
            delta = plan["slice_z"][s] - e_k
            a01, b01 = e_a + delta * v, e_b + delta * u
            mask = (_in01(a01)[:, None] & _in01(b01)[None, :]
                    & ((delta * plan["sign"]) > 0.0))
            t = _mm(resample_matrix(a01, A), gperm[k], tf32)
            sigma = _mm(t, resample_matrix(b01, B).T, tf32) * scale \
                * mask.float()
            live = trans > thresh
            if counts is not None:
                counts.add(mask & live)
            alpha = live.float() * (1.0 - torch.exp(-density * sigma
                                                    * seglen))
            shade = 1.0
            if lperm is not None:
                lt = _light_sample(lperm[k], a01, b01)
                shade = ambient + (1.0 - ambient) * torch.clamp(lt, 0.0, 1.0)
            wsum = wsum + trans * alpha * shade
            trans = trans * (1.0 - alpha)
        return trans, wsum

    kw = dict(dtype=torch.float32, device=grid.device)
    carry = (torch.ones((plan["Hb"], plan["Wb"]), **kw),
             torch.zeros((plan["Hb"], plan["Wb"]), **kw))
    for s0 in range(0, S, CHUNK):
        s1 = min(s0 + CHUNK, S)
        if torch.is_grad_enabled() and grid.requires_grad:
            carry = checkpoint(slices, s0, s1, *carry, use_reentrant=False)
        else:
            carry = slices(s0, s1, *carry)
    return carry


def finish(trans, wsum, plan, med):
    """The (H, W, 4) RGBA frame from the base maps."""
    base = torch.stack([wsum, trans], dim=-1)
    Hb, Wb = base.shape[:2]

    def taps(q, n):
        p = torch.clamp(q * n - 0.5, 0.0, float(n - 1))
        i0f = torch.floor(p)
        i0 = i0f.to(torch.int64)
        return i0, torch.clamp(i0 + 1, max=n - 1), (p - i0f)[..., None]

    rows, cols = plan["rows01"], plan["cols01"]
    r0, r1, fr = taps(rows, Hb)
    c0, c1, fc = taps(cols, Wb)
    out = ((1.0 - fc) * ((1.0 - fr) * base[r0, c0] + fr * base[r1, c0])
           + fc * ((1.0 - fr) * base[r0, c1] + fr * base[r1, c1]))
    miss = torch.tensor([0.0, 1.0], device=out.device)
    out = torch.where((_in01(rows) & _in01(cols))[..., None], out, miss)
    lcol = torch.tensor(med["light_color"], device=out.device)
    bg = torch.tensor(med["background"], device=out.device)
    rgb = out[..., 0:1] * lcol + out[..., 1:2] * bg
    return torch.cat([rgb, (1.0 - out[..., 1])[..., None]], dim=-1)


def render(grid, plan, med, lvol=None, tf32=False, counts=None):
    trans, wsum = sweep_maps(grid, plan, med, lvol, tf32, counts)
    return finish(trans, wsum, plan, med)


def light_volume(grid, med, tf32=False):
    """(D, H, W) transmittance toward the directional light."""
    sigma = grid * med["sample_scale"]
    ldir = np.asarray(med["light_direction"], np.float64)
    ldir = ldir / np.linalg.norm(ldir)
    w = ldir / 2.0  # the [-1, 1] box's range
    axis = int(np.argmax(np.abs(w)))
    sign = 1 if w[axis] > 0 else -1
    gd_k = 2 - axis
    rest = [d for d in range(3) if d != gd_k]
    perm = (gd_k, rest[0], rest[1])
    c_a, c_b = 2 - rest[0], 2 - rest[1]
    gperm = sigma.permute(perm)
    S, A, B = gperm.shape
    dev = gperm.device
    dz = 1.0 / S
    shift_a = dz * w[c_a] / abs(w[axis])
    shift_b = dz * w[c_b] / abs(w[axis])
    dl = dz * float(np.sqrt(4.0 + (shift_a / dz * 2.0) ** 2
                            + (shift_b / dz * 2.0) ** 2))

    def shear(n, shift):
        x01 = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n \
            + float(np.float32(shift))
        return _vacuum_matrix(x01, n)

    wa, wbt = shear(A, shift_a), shear(B, shift_b).T
    order = list(range(S - 1, -1, -1) if sign > 0 else range(S))
    tau = torch.zeros((A, B), dtype=torch.float32, device=dev)
    taus = [None] * S
    taus[order[0]] = tau
    for k_prev, k in zip(order, order[1:]):
        tau = _mm(_mm(wa, tau + gperm[k_prev] * dl, tf32), wbt, tf32)
        taus[k] = tau
    lv = torch.exp(-med["density"] * torch.stack(taus))
    return lv.permute(tuple(int(i) for i in np.argsort(perm)))


def fit_steps(target, plan, med, size, lr, steps, tf32=False,
              half_batch=False):
    """The fit's first `steps` steps from the constant 0.1 grid: (losses,
    the first gradient, the grid's change after the last step). half_batch
    (a planted fault): the loss is the mean over the top half of the rows
    only."""
    dev = target.device
    grid = torch.full((size,) * 3, 0.1, dtype=torch.float32, device=dev)
    m = torch.zeros_like(grid)
    v = torch.zeros_like(grid)
    losses, g1 = [], None
    for t in range(1, steps + 1):
        g = grid.detach().requires_grad_(True)
        rgb = render(g, plan, med, tf32=tf32)[..., :3]
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
    return losses, g1, grid - 0.1
