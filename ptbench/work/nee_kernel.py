"""#3, the NEE megakernel's production instances (raster and persistent):
a lower bound on the work of one unit.

Counted: the first bounce of every sample whose primary ray hits (the dual
fold over the table, the least bounce work and the light sample), and per
launch the pixels' bytes and the tables.  Left out: every later bounce, the
primary fold (the probe does it in the sorted frame), normals, emission and
the other BRDFs.  So the share of the roofline reads below the truth.
"""

from . import peaks as P

MATCH = r"(?<![A-Za-z0-9_])nee_(persistent_)?kernel<\s*\w+,\s*\w+,\s*false\s*>"


def per_bounce_ops(inp) -> int:
    ops = sum(n * f for n, f in zip(inp.counts, P.DUAL_FOLD_OPS)) + P.NEE_BOUNCE_OPS
    return ops + (P.NEE_LIGHT_OPS if inp.lights else 0)


def work(inp, launches: float):
    ops = inp.spp * inp.hits * per_bounce_ops(inp)
    nbytes = launches * (inp.pixels * P.NEE_BYTES_PER_PIXEL + P.table_bytes(inp.counts, inp.lights))
    return ops, nbytes
