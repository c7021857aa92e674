"""#3r, the NEE megakernel's recording instances (the gradient's forward):
a lower bound on the work of one unit.

Counted as #3 (`nee_kernel.py`): the first bounce of every sample whose
primary ray hits, the pixels' bytes and the tables per launch, and the
residual word of that first bounce (4 B).  Left out: every later bounce and
word, the primary fold and the sorted frame's lane order.
"""

from . import nee_kernel

MATCH = r"(?<![A-Za-z0-9_])nee_(persistent_)?kernel<\s*\w+,\s*\w+,\s*true\s*>"


def work(inp, launches: float):
    ops, nbytes = nee_kernel.work(inp, launches)
    return ops, nbytes + 4 * inp.spp * inp.hits
