"""K1 (tau kernel, homogeneous) share of its roofline (%): its launches'
bounds from their shapes over their device time in the trace."""
from portbench import roofline


def read(rec):
    return roofline.share(rec, "tau")
