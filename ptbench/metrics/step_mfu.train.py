"""The steps' counted fp32 work, all the cell's kernels, as a share of the
chip's fp32 peak over the window, in %: a lower bound on the whole step's
use of the chip, which bounds any one kernel's gain."""

from ptbench.trace import step_mfu_pct

LAYER = "csrc kernels"
MOVES = "sgd_step_ms"


def read(rec):
    return step_mfu_pct(rec)
