"""Device kernel launches per frame, the port's and PyTorch's, counted in
the profiler's trace."""

LAYER = "launch wrappers"
MOVES = "render_paths_per_s"


def read(rec):
    return len(rec.kernel_events()) / rec.units if rec.units else None
