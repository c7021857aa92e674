"""The step's main kernel (the cell's first kernel: #2s in the parity step,
#3r in the NEE step) as a share of its roofline, in %: the lower bound of
its work (`ptbench/work/`) over its device time in the trace."""

from ptbench.trace import roofline_pct

LAYER = "csrc kernels"
MOVES = "sgd_step_ms"


def read(rec):
    return roofline_pct(rec)
