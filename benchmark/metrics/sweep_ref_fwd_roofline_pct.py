"""sweep_ref_fwd_roofline_pct (%, device trace): the 4-channel forward
sweep kernel's (K4, kernels/sweep_ref_fwd.py) share of its roofline over
the profiled stretch: the least time the work of its launches needs
(roofline_ref.py, from the benchmark's own geometry and count) over their
device time by kernel name."""
from benchmark import roofline_ref


def read(run):
    return roofline_ref.share_pct(run)
