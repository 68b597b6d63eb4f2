"""The least time the card could take for the 4-channel forward sweep
kernel's work (K4: volumetricrenderer_tpu_torch/kernels/sweep_ref_fwd.py +
csrc/sweep_ref_fwd.cu), for the reference configuration's cells.

The peaks are roofline.py's. The operation counts are a copy, taken at
commit 06d54a1, of chip_smoke.py's for sweep_ref_fwd, per sample in the
box and in front of the eye: four bilinear sums (36) and the combine (4),
then in place of the emission's exp's argument, exp, alpha and two carries
(8, chip_smoke.py's 48 in all) the absorption's acc += sigma * seglen (2)
and hit = max(hit, in box) (1): 43. Per line (a row or a column of a
slice that holds such a sample): the coordinate (2), then per channel its
scale and scroll (2) and p, floor, f, 1 - f (5) = 30. The samples counted
are those the reference's own sweep needs (reference_ref.Counts): in
absorption every one in the box and in front of the eye, so that the
count depends on the camera alone. Bytes: the (S, 4, A, B) float32 layer
stack read once, the slice positions, the base grid's axes, seglen and
the 20 parameters read once, the four (Hb, Wb) float32 base maps written
once.
"""
from __future__ import annotations

from benchmark.roofline import F32, bound_s

KERNEL = "sweep_ref_fwd_kernel"  # the CUDA kernel's name in the trace
FLOP_PER_SAMPLE, FLOP_PER_LINE = 43, 30
N_PARAMS = 20


def work(samples, lines, S, A, B, Hb, Wb):
    """(flops, bytes) of one K4 launch in absorption."""
    flops = FLOP_PER_SAMPLE * samples + FLOP_PER_LINE * lines
    nbytes = (S * 4 * A * B + S + Hb + Wb + N_PARAMS + Hb * Wb
              + 4 * Hb * Wb) * F32
    return flops, nbytes


def share_pct(run):
    """K4's share of its roofline over a traced run's profiled stretch, in
    %: the least time its launches' work needs over the device time of the
    kernels named KERNEL. None where the run profiled no launch of it."""
    import torch

    from benchmark import plan as bplan
    from benchmark import reference_ref
    profile, items = run.get("profile"), run.get("profiled_work")
    if not profile or not items:
        return None
    seconds = sum(s for name, s in profile["device_s_by_name"].items()
                  if KERNEL in name)
    if seconds <= 0.0:
        return None
    cache = run.setdefault("work_cache", {})
    need = 0.0
    for item in items:
        launches = item["launches"].get("sweep_ref_fwd", 0)
        if not launches:
            continue
        grid, cam = item["grid"], item["camera"]
        key = (id(grid), tuple(cam["eye"]))
        if key not in cache:
            plan = bplan.make_plan(
                cam, grid.shape[:3], grid.device,
                run["config"]["render"]["sweep_supersample"])
            counts = reference_ref.Counts(grid.device)
            reference_ref.render(grid, plan, run["med"], item["scroll"],
                                 counts=counts)
            S, A, B = (grid.shape[p] for p in plan["perm"])
            cache[key] = (*counts.read(), S, A, B, plan["Hb"], plan["Wb"])
        samples, lines, S, A, B, Hb, Wb = cache[key]
        need += launches * bound_s(*work(samples, lines, S, A, B, Hb, Wb))
    return 100.0 * need / seconds if need else None
