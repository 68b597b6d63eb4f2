"""The roofline count against a hand count on a tiny geometry: the
samples in the box, in front of the eye and on a live line, and the
rows and columns that hold one, by plain Python loops; and the
operations and bytes of one launch written out."""
import math

import torch

from benchmark import plan as bplan
from benchmark import reference, roofline

MED = {"density": 8.0, "sample_scale": 0.2, "early_stop_transmittance": 1e-3,
       "ambient": 0.1, "light_color": [1, 1, 1], "background": [0, 0, 0],
       "light_direction": [0.5, 0.5, 1.0]}
CAM = {"eye": [0.3, -0.2, 3.0], "center": [0.0, 0.0, 0.0],
       "up": [0.0, 1.0, 0.0], "fov_y_degrees": 40.0, "width": 10,
       "height": 8}


def _hand_count(grid, plan):
    """Per base line, march the slices front to back in Python floats,
    counting a sample while the line is live."""
    gperm = grid.permute(plan["perm"]).double()
    S, A, B = gperm.shape
    flip = plan["sign"] < 0
    e = [float(x) for x in plan["eye01"]]
    v = [float(x) for x in plan["v_grid"]]
    u = [float(x) for x in plan["u_grid"]]
    seg = plan["seglen"].double()
    samples, lines = 0, 0
    trans = [[1.0] * len(u) for _ in v]
    for s in range(S):
        z = float(plan["slice_z"][s])
        delta = z - e[0]
        if delta * plan["sign"] <= 0.0:
            continue
        k = S - 1 - s if flip else s
        live_rows, live_cols = set(), set()
        for i, vi in enumerate(v):
            a = e[1] + delta * vi
            for j, uj in enumerate(u):
                b = e[2] + delta * uj
                if not (0.0 <= a <= 1.0 and 0.0 <= b <= 1.0):
                    continue
                if trans[i][j] <= MED["early_stop_transmittance"]:
                    continue
                samples += 1
                live_rows.add(i)
                live_cols.add(j)
                x, y = a * A - 0.5, b * B - 0.5
                i0, j0 = math.floor(x), math.floor(y)
                fa, fb = x - i0, y - j0

                def t(ii, jj):
                    m = lambda q, n: q % (2 * n) if q % (2 * n) < n \
                        else 2 * n - 1 - q % (2 * n)  # noqa: E731
                    return float(gperm[k, m(ii, A), m(jj, B)])
                val = ((1 - fa) * ((1 - fb) * t(i0, j0) + fb * t(i0, j0 + 1))
                       + fa * ((1 - fb) * t(i0 + 1, j0)
                               + fb * t(i0 + 1, j0 + 1)))
                tau = MED["density"] * MED["sample_scale"] * val \
                    * float(seg[i, j])
                trans[i][j] *= math.exp(-tau)
        lines += len(live_rows) + len(live_cols)
    return samples, lines


def test_count_matches_hand_count_without_early_stop():
    grid = torch.zeros((6, 5, 4))
    plan = bplan.make_plan(CAM, grid.shape, "cpu", force_dims=(7, 9))
    counts = reference.Counts("cpu")
    reference.sweep_maps(grid, plan, MED, counts=counts)
    assert counts.read() == _hand_count(grid, plan)
    assert counts.read()[0] > 0


def test_count_stops_where_lines_end():
    grid = torch.zeros((6, 5, 4))
    grid[1:] = 40.0  # opaque after the first layers: lines end early
    plan = bplan.make_plan(CAM, grid.shape, "cpu", force_dims=(7, 9))
    counts = reference.Counts("cpu")
    reference.sweep_maps(grid, plan, MED, counts=counts)
    full = reference.Counts("cpu")
    reference.sweep_maps(torch.zeros_like(grid), plan, MED, counts=full)
    assert counts.read() == _hand_count(grid, plan)
    assert counts.read()[0] < full.read()[0]


def test_work_of_one_launch():
    S, A, B, Hb, Wb = 4, 5, 6, 7, 8
    flops, nbytes = roofline.work("sweep_fwd", 100, 10, S, A, B, Hb, Wb,
                                  False)
    assert flops == 18 * 100 + 7 * 10
    assert nbytes == 4 * (S * A * B + S + Hb + Wb + 8 + Hb * Wb
                          + 4 * Hb * Wb)
    flops, nbytes = roofline.work("sweep_bwd", 100, 10, S, A, B, Hb, Wb,
                                  False)
    assert flops == 36 * 100 + 7 * 10
    assert nbytes == 4 * (2 * S * A * B + S + Hb + Wb + 8 + 6 * Hb * Wb)
    assert roofline.bound_s(67e12, 0.0) == 1.0
    assert roofline.bound_s(0.0, 3.35e12) == 1.0
