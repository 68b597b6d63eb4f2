"""The least time the card could take for a sweep kernel's work.

The operation counts per sample and per line and the published peaks are
a copy, taken at commit 38e9ffd, of chip_smoke.py's FLOP_PER_SAMPLE,
FLOP_PER_LINE, PEAK_FLOPS and PEAK_BYTES. Float operations the swept
function needs (emission), an exp counted as one:

  sweep_fwd: the bilinear sum (6 products, 3 adds), sigma (1), exp's
    argument (2), exp (1), alpha (1), wsum += T * alpha (2),
    T *= 1 - alpha (2)                                                = 18
  sweep_bwd: the forward's 18 for the replay, A~ (2), dsigma (5), its
    sample_scale (1), the bilinear adjoint (6 products, 4 adds)       = 36
  with a light volume, forward 14 more (the light's bilinear sum, the
  clip, the shade and its product into wsum); backward 31 more.
  per line (a row or a column of a slice that holds a sample): the
  coordinate e + delta * slope (2), p = x * n - 0.5 (2), floor (1),
  f (1), 1 - f (1)                                                    = 7

Unlike chip_smoke.py, which counted every sample in the box and called
that an upper bound, the samples counted here are those the reference's
own sweep needs: in the box, in front of the eye, and on a line whose
transmittance is still above the early-stop threshold
(reference.Counts). Bytes count each input read once and each output
written once. The peaks are the H100 SXM data sheet's at its 700 W limit:
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of memory.
"""
from __future__ import annotations

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
FLOP_PER_SAMPLE = {"sweep_fwd": 18, "sweep_bwd": 36,
                   "sweep_fwd+light": 32, "sweep_bwd+light": 67}
FLOP_PER_LINE = 7
F32 = 4


def work(kernel: str, samples: int, lines: int, S: int, A: int, B: int,
         Hb: int, Wb: int, light: bool) -> tuple:
    """(flops, bytes) of one launch of `kernel` on a (S, A, B) float32
    stack and an (Hb, Wb) base grid."""
    key = kernel + ("+light" if light else "")
    flops = FLOP_PER_SAMPLE[key] * samples + FLOP_PER_LINE * lines
    stack = S * A * B * F32 * (2 if light else 1)
    small = (S + Hb + Wb + 8) * F32
    base = Hb * Wb * F32
    if kernel == "sweep_fwd":
        nbytes = stack + small + base + 4 * base       # + seglen; out maps
    else:
        nbytes = stack + small + base + 5 * base + stack  # 3 cts, T, wsum
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _kernel_seconds(profile, kernel):
    """Device seconds of the profiled stretch in kernels named after
    `kernel` (the single-channel sweep's, not the 4-channel ones)."""
    return sum(s for name, s in profile["device_s_by_name"].items()
               if kernel in name and "ref" not in name)


def share_pct(run, kernel):
    """The kernel's share of its roofline over a traced run's profiled
    stretch, in %: the least time its launches' work needs over the
    device time they took. None where the run profiled no launch of it."""
    import torch

    from benchmark import plan as bplan
    from benchmark import reference
    profile, items = run.get("profile"), run.get("profiled_work")
    if not profile or not items:
        return None
    seconds = _kernel_seconds(profile, kernel)
    if seconds <= 0.0:
        return None
    cache = run.setdefault("work_cache", {})
    need = 0.0
    for item in items:
        launches = item["launches"].get(kernel, 0)
        if not launches:
            continue
        grid, cam = item["grid"], item["camera"]
        key = (id(grid), tuple(cam["eye"]), item["dims"])
        if key not in cache:
            plan = bplan.make_plan(
                cam, grid.shape, grid.device,
                run["config"]["render"]["sweep_supersample"], item["dims"])
            counts = reference.Counts(grid.device)
            with torch.no_grad():
                reference.sweep_maps(grid, plan, run["med"], counts=counts)
            S, A, B = grid.permute(plan["perm"]).shape
            cache[key] = (*counts.read(), S, A, B, plan["Hb"], plan["Wb"])
        samples, lines, S, A, B, Hb, Wb = cache[key]
        flops, nbytes = work(kernel, samples, lines, S, A, B, Hb, Wb,
                             item["light"])
        need += launches * bound_s(flops, nbytes)
    return 100.0 * need / seconds if need else None
