"""sweep_ref_fwd_roofline_pct.train (%, device trace): the 4-channel
forward sweep kernel's (K4, kernels/sweep_ref_fwd.py) share of its
roofline over a fit's profiled steps, as sweep_ref_fwd_roofline_pct reads
it over a viewer's frames (roofline_ref.py)."""
from benchmark import roofline_ref


def read(run):
    return roofline_ref.share_pct(run)
