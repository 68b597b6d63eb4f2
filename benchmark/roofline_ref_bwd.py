"""The least time the card could take for the 4-channel backward sweep
kernel's work (K5: volumetricrenderer_tpu_torch/kernels/sweep_ref_bwd.py +
csrc/sweep_ref_bwd.cu), for the reference configuration's fit.

The peaks are roofline.py's. The operation counts follow chip_smoke.py's
for sweep_ref_bwd in emission, as roofline_ref.py's follow its
sweep_ref_fwd: there, per sample in the box and in front of the eye, the
forward's 48 for the replay (four bilinear sums 36, the combine 4, exp's
argument, exp, alpha and the two carries 8), A~ (2), dsigma (5), its
sample_scale (1), the product rule on the combine's r0 * r1 and r2 + r3
(5) and four bilinear adjoints (40): 101. In absorption, the
configuration's mode, dsigma = ct_acc * seglen needs no transmittance, so
the replay keeps only what the product rule reads: the four bilinear sums
(36), r0 * r1 and r2 + r3 (2); then dsigma (1), its sample_scale (1), the
product rule (5) and the four bilinear adjoints (40): 85. Per line (a row
or a column of a slice that holds such a sample): chip_smoke.py's 30, the
forward's. The samples counted are those the reference's own sweep needs
(reference_ref.Counts), as for K4: in absorption every one in the box and
in front of the eye, so that the count depends on the camera alone.
Bytes: the (S, 4, A, B) float32 layer stack read once and its gradient
written once, the slice positions, the base grid's axes, seglen, the
acc map's cotangent and the 20 parameters read once.
"""
from __future__ import annotations

from benchmark.roofline import F32, bound_s

KERNEL = "sweep_ref_bwd_kernel"  # the CUDA kernel's name in the trace
FLOP_PER_SAMPLE, FLOP_PER_LINE = 85, 30
N_PARAMS = 20


def work(samples, lines, S, A, B, Hb, Wb):
    """(flops, bytes) of one K5 launch in absorption."""
    flops = FLOP_PER_SAMPLE * samples + FLOP_PER_LINE * lines
    nbytes = (2 * S * 4 * A * B + S + Hb + Wb + N_PARAMS
              + 2 * Hb * Wb) * F32
    return flops, nbytes


def counts(run, item):
    """(samples, lines, S, A, B, Hb, Wb) of a profiled item's camera on its
    grid, counted by the reference's own sweep once per grid and camera
    (the cache and its key are roofline_ref.py's)."""
    from benchmark import plan as bplan
    from benchmark import reference_ref
    grid, cam = item["grid"], item["camera"]
    cache = run.setdefault("work_cache", {})
    key = (id(grid), tuple(cam["eye"]))
    if key not in cache:
        plan = bplan.make_plan(cam, grid.shape[:3], grid.device,
                               run["config"]["render"]["sweep_supersample"])
        tally = reference_ref.Counts(grid.device)
        reference_ref.render(grid, plan, run["med"], item.get("scroll"),
                             counts=tally)
        S, A, B = (grid.shape[p] for p in plan["perm"])
        cache[key] = (*tally.read(), S, A, B, plan["Hb"], plan["Wb"])
    return cache[key]


def share_pct(run):
    """K5's share of its roofline over a traced run's profiled stretch, in
    %: the least time its launches' work needs over the device time of the
    kernels named KERNEL. None where the run profiled no launch of it."""
    profile, items = run.get("profile"), run.get("profiled_work")
    if not profile or not items:
        return None
    seconds = sum(s for name, s in profile["device_s_by_name"].items()
                  if KERNEL in name)
    if seconds <= 0.0:
        return None
    need = 0.0
    for item in items:
        launches = item["launches"].get("sweep_ref_bwd", 0)
        if launches:
            need += launches * bound_s(*work(*counts(run, item)))
    return 100.0 * need / seconds if need else None
