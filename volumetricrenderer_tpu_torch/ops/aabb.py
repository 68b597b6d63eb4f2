"""Ray / axis-aligned-box intersection by the slab method (port of
volumetricrenderer_tpu/ops/aabb.py): t_near is the largest per-axis entry
time, t_far the smallest per-axis exit time."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["intersect_aabb"]


def intersect_aabb(origins, directions, box_min, box_max,
                   eps=1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab intersection of rays with one AABB.

    origins, directions: (..., 3); box_min/box_max: (3,) or broadcastable.
    Returns (t_near, t_far), each (...). A ray hits iff t_near <= t_far and
    t_far >= 0. Direction components below eps in magnitude are replaced by
    a signed eps, so a ray in a box face plane gives no 0/0 NaN."""
    d = torch.as_tensor(directions, dtype=torch.float32)
    o = torch.as_tensor(origins, dtype=torch.float32, device=d.device)
    box_min = torch.as_tensor(box_min, dtype=torch.float32, device=d.device)
    box_max = torch.as_tensor(box_max, dtype=torch.float32, device=d.device)

    eps_t = torch.full_like(d, eps)
    safe_d = torch.where(d.abs() < eps, torch.where(d < 0, -eps_t, eps_t), d)
    inv_d = 1.0 / safe_d
    t_min = (box_min - o) * inv_d
    t_max = (box_max - o) * inv_d
    t1 = torch.minimum(t_min, t_max)
    t2 = torch.maximum(t_min, t_max)
    return t1.amax(dim=-1), t2.amin(dim=-1)
