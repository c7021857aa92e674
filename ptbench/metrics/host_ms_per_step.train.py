"""Host time from a step's start to its loss read, per step, in ms:
`loss_and_grad` (autograd, `image_loss`, the launches) and the update, with
any wait on the device inside them; the loss read itself is left out."""

from ptbench.trace import per_unit

LAYER = "gradient host work"
MOVES = "sgd_step_ms"


def read(rec):
    return per_unit(rec.span_seconds("ptbench.step"))
