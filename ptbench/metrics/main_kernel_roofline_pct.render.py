"""The frame's main kernel (#3, the NEE megakernel) as a share of its
roofline, in %: the lower bound of its work (`ptbench/work/`, the cell's
first kernel) over its device time in the trace."""

from ptbench.trace import roofline_pct

LAYER = "csrc kernels"
MOVES = "render_paths_per_s"


def read(rec):
    return roofline_pct(rec)
