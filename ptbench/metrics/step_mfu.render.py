"""The frames' counted fp32 work, all the cell's kernels, as a share of the
chip's fp32 peak over the window, in %: a lower bound on the whole frame's
use of the chip, which bounds any one kernel's gain."""

from ptbench.trace import step_mfu_pct

LAYER = "csrc kernels"
MOVES = "render_paths_per_s"


def read(rec):
    return step_mfu_pct(rec)
