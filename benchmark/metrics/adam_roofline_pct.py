"""adam_roofline_pct (%, program span): the optimizer's share of its
roofline: the least time Adam and the clamp need, 28 B a voxel over the
card's peak bandwidth (optimizer_roofline.py), over the device interval
of the program's "fit.adam" per "fit.step" of a traced run's profiled
stretch."""
from benchmark import optimizer_roofline


def read(run):
    return optimizer_roofline.share_pct(run)
