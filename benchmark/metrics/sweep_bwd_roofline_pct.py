"""sweep_bwd_roofline_pct (%, device trace): the backward sweep kernel's
(K2, kernels/sweep_bwd.py) share of its roofline over the profiled
stretch: the least time the work of its launches needs (roofline.py,
from the benchmark's own geometry and count) over their device time."""
from benchmark import roofline


def read(run):
    return roofline.share_pct(run, "sweep_bwd")
