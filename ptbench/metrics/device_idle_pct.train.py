"""The share of the traced window, in %, in which no device activity ran."""

LAYER = "device"
MOVES = "sgd_step_ms"


def read(rec):
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s) if rec.window_s > 0 else None
