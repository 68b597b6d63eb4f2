"""sweep_fwd_roofline_pct (%, device trace): the forward sweep kernel's
(K1, kernels/sweep_fwd.py) share of its roofline over the profiled
stretch: the least time the work of its launches needs (roofline.py,
from the benchmark's own geometry and count) over their device time."""
from benchmark import roofline


def read(run):
    return roofline.share_pct(run, "sweep_fwd")
