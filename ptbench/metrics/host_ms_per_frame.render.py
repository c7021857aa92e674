"""Host time inside the `Renderer.render` call, per frame, in ms: the
renderer's and the NEE path's host work (tables, primary rays, presort,
launches) with any wait on the device inside the call."""

from ptbench.trace import per_unit

LAYER = "render host work"
MOVES = "render_paths_per_s"


def read(rec):
    return per_unit(rec.span_seconds("ptbench.render"))
