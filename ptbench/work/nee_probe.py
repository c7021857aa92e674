"""#4, the primary-hit probe: the work of one unit.

Counted per launch: the primary fold of every pixel over the whole table at
eps 0, the rays read (24 B) and (t0, prim0) written (8 B), the fold table.
"""

from . import peaks as P

MATCH = r"(?<![A-Za-z0-9_])probe_kernel<"


def work(inp, launches: float):
    ops = launches * inp.pixels * P.primary_fold_ops(inp.counts)
    nbytes = launches * (inp.pixels * P.PROBE_BYTES_PER_RAY + 4 * P.fold_floats(inp.counts))
    return ops, nbytes
