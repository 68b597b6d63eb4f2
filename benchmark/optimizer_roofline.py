"""The least time the card could take for the fit's optimizer step, and
the step's share of that roofline.

fit_grid's update is Adam (betas 0.9, 0.999, eps 1e-8, bias-corrected) on
the one float32 grid, then the clamp to [0, 1]. Whatever implements it
(torch's foreach kernels, a fused Adam, a kernel of the port's own), per
voxel the update has to

  read   the grid, its gradient, Adam's first and second moment   4 words
  write  the grid, the first and the second moment                3 words

and the clamp, fused into the grid's write, needs nothing more: 7 words,
28 B a voxel in float32 (BYTES_PER_VOXEL). Its arithmetic, about 15
operations a voxel (two moment updates, a square root, a division, the
bias corrections, the clamp), is about 0.5 operations a byte, far under
the card's 20 at its peaks (roofline.py's 67 TFLOP/s over 3.35 TB/s), so
the bytes bound it:

  least seconds = BYTES_PER_VOXEL * voxels / PEAK_BYTES

3.76 GB and 1.12 ms at 512^3, 0.47 GB and 0.14 ms at 256^3. The peak is
roofline.py's: the H100 SXM data sheet's 3.35 TB/s at its 700 W limit.
Imports nothing of the program.
"""
from __future__ import annotations

from benchmark import program_spans
from benchmark.roofline import PEAK_BYTES

WORDS_READ, WORDS_WRITTEN = 4, 3
BYTES_PER_VOXEL = (WORDS_READ + WORDS_WRITTEN) * 4


def least_s(voxels: int) -> float:
    """Seconds one optimizer step over `voxels` float32 voxels needs at
    the card's peak bandwidth."""
    return BYTES_PER_VOXEL * voxels / PEAK_BYTES


def share_pct(run):
    """The optimizer's share of its roofline over a traced run's profiled
    steps, in %: least_s of the fitted grid's voxels (the grid drivers/fit.py
    kept in "profiled_work") over the device interval of the program's
    "fit.adam" per step. None where either is missing."""
    items = run.get("profiled_work")
    if not items:
        return None
    ms = program_spans.per_step_ms(run, ("fit.adam",), device=True)
    if not ms:
        return None
    return 100.0 * least_s(items[0]["grid"].numel()) / (ms * 1e-3)
