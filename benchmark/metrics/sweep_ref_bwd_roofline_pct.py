"""sweep_ref_bwd_roofline_pct (%, device trace): the 4-channel backward
sweep kernel's (K5, kernels/sweep_ref_bwd.py) share of its roofline over
the profiled stretch: the least time the work of its launches needs
(roofline_ref_bwd.py, from the benchmark's own geometry and count) over
their device time by kernel name."""
from benchmark import roofline_ref_bwd


def read(run):
    return roofline_ref_bwd.share_pct(run)
