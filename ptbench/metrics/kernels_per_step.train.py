"""Device kernel launches per SGD step, the port's and PyTorch's, counted in
the profiler's trace."""

LAYER = "launch wrappers"
MOVES = "sgd_step_ms"


def read(rec):
    return len(rec.kernel_events()) / rec.units if rec.units else None
