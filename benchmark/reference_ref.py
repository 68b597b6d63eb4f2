"""The plain reference of the reference configuration: the upstream
renderer's 4-channel medium, rendered by the slice sweep in plain PyTorch.

It imports nothing of the program. It follows the definitions the port's
plain versions state (volumetricrenderer_tpu_torch/kernels/sweep_ref_fwd.py
_channel_offsets, _layer_channels and sweep_ref_fwd_reference,
kernels/build.py channel_resample, ops/sweep.py finish_image), on the
geometry of plan.py:

* channel c's offsets: its row of the (4, 3) scroll times its scroll
  weight, read in the plan's (k, a, b) coordinate order;
* per slice s, front to back, per channel c: the two layers of channel c
  bracketing the sweep coordinate z_s * scale_c + off_k,c (texel centres,
  mirror addressing), lerped; then that slab's bilinear sample at
  (a * scale_c + off_a,c, b * scale_c + off_b,c), mirror addressing, as
  two banded matrix products Wa_c @ G_c @ Wb_c^T, where (a, b) are the
  unscaled coordinates at which the base grid's rays cross the slice;
* sigma = (s1 * s2) * (s3 + s4) * sample_scale, zero where (a, b) leaves
  the box or the slice lies behind the eye;
* Beer-Lambert absorption, the configuration's mode: acc += sigma *
  seglen, hit = max(hit, in box), every sample counted (absorption has no
  early stop);
* (acc, hit) warped to the pixels by reference.py's clip-then-tent taps,
  pixels off the base grid (0, 0); gray = 1 - exp(-density * acc),
  hitp = clip(hit, 0, 1), rgb = gray * hitp + background * (1 - hitp),
  alpha = hitp.

Departures from the program's plain version, none of which changes the
function: each channel's two layers are lerped slice by slice instead of
as one (S, 4, A, B) stack; the box test zeroes sigma alone (the program
also zeroes Wa's rows outside the box, whose products the test zeroes
anyway). Emission and a light volume, which the configuration does not
use, are left out.

Everything is float32 with TF32 off. tf32=True rounds every operand of
every matrix product to TF32 (reference.tf32_round): the control, the same
computation one precision below the configuration's.
"""
from __future__ import annotations

import contextlib

import torch

from benchmark.reference import Counts, _in01, _mirror, _mm, resample_matrix

__all__ = ["Counts", "offsets", "sweep_maps", "finish", "render"]


def offsets(scroll, med, perm, device):
    """(4, 3) float32: channel c's scroll offsets in the plan's (k, a, b)
    order (zeros without a scroll)."""
    if scroll is None:
        return torch.zeros((4, 3), dtype=torch.float32, device=device)
    weight = torch.tensor(med["channel_scroll_weight"], dtype=torch.float32,
                          device=device)
    off = scroll.to(device, torch.float32) * weight[:, None]
    return off[:, [2 - p for p in perm]]


def _layer(gc, qk):
    """Channel slab gc (S, A, B) lerped at the normalized sweep coordinate
    qk (0-dim), between its two bracketing layers."""
    n = gc.shape[0]
    p = qk * n - 0.5
    i0f = torch.floor(p)
    f = p - i0f
    i0 = i0f.to(torch.int64)
    return gc[_mirror(i0, n)] * (1.0 - f) + gc[_mirror(i0 + 1, n)] * f


def sweep_maps(grid, plan, med, scroll=None, tf32=False, counts=None):
    """(acc, hit) base maps, each (Hb, Wb), of a (D, H, W, 4) grid under a
    plan (plan.py) and an optional (4, 3) scroll."""
    perm = tuple(plan["perm"])
    gperm = grid.permute(*perm, 3).to(torch.float32)
    S, A, B, _ = gperm.shape
    chans = [gperm[..., c] for c in range(4)]
    off = offsets(scroll, med, perm, grid.device)
    scale = med["channel_coord_scale"]
    e_k, e_a, e_b = plan["eye01"][0], plan["eye01"][1], plan["eye01"][2]
    v, u, seglen = plan["v_grid"], plan["u_grid"], plan["seglen"]
    acc = torch.zeros((plan["Hb"], plan["Wb"]), dtype=torch.float32,
                      device=grid.device)
    hit = torch.zeros_like(acc)
    for s in range(S):
        z = plan["slice_z"][s]
        delta = z - e_k
        a01, b01 = e_a + delta * v, e_b + delta * u
        mask = (_in01(a01)[:, None] & _in01(b01)[None, :]
                & ((delta * plan["sign"]) > 0.0))
        if counts is not None:
            counts.add(mask)
        r = []
        for c in range(4):
            slab = _layer(chans[c], z * scale[c] + off[c, 0])
            wa = resample_matrix(a01 * scale[c] + off[c, 1], A)
            wb = resample_matrix(b01 * scale[c] + off[c, 2], B)
            r.append(_mm(_mm(wa, slab, tf32), wb.T, tf32))
        sigma = (r[0] * r[1]) * (r[2] + r[3]) * med["sample_scale"] \
            * mask.float()
        acc = acc + sigma * seglen
        hit = torch.maximum(hit, mask.float())
    return acc, hit


def finish(acc, hit, plan, med):
    """The (H, W, 4) RGBA frame from the base maps."""
    base = torch.stack([acc, hit], dim=-1)
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
    out = torch.where((_in01(rows) & _in01(cols))[..., None], out,
                      torch.zeros((), device=out.device))
    gray = 1.0 - torch.exp(-med["density"] * out[..., 0])
    hitp = torch.clamp(out[..., 1], 0.0, 1.0)
    bg = torch.tensor(med["background"], dtype=torch.float32,
                      device=out.device)
    rgb = gray[..., None] * hitp[..., None] + bg * (1.0 - hitp[..., None])
    return torch.cat([rgb, hitp[..., None]], dim=-1)


@contextlib.contextmanager
def _no_tf32():
    """float32 matrix products in float32 on a card, whatever the process
    set (the control rounds its operands itself)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def render(grid, plan, med, scroll=None, tf32=False, counts=None):
    """The (H, W, 4) RGBA frame; counts: a Counts tallying the samples."""
    with _no_tf32(), torch.no_grad():
        acc, hit = sweep_maps(grid, plan, med, scroll, tf32, counts)
        return finish(acc, hit, plan, med)
