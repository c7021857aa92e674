"""#1', the parity megakernel's recording instance (the gradient's forward):
a lower bound on the work of one unit.

Counted: per launch the primary fold of every pixel, then for every sample
whose primary ray hits the first bounce's shading by its winner's kind and
BRDF (`peaks.BOUNCE_OPS`, `NORMAL_OPS`, `SAMPLE_OPS`); per launch the
pixels' bytes, the rng written at every sample's start (16 B) and the
tables.  Left out: every later bounce and its fold.
"""

from . import peaks as P

MATCH = r"(?<![A-Za-z0-9_])megakernel<\s*\w+,\s*\w+,\s*\w+,\s*true\s*>"


def work(inp, launches: float):
    fold = sum(n * f for n, f in zip(inp.counts, P.FOLD_OPS))
    shade = sum(n * (P.BOUNCE_OPS + P.NORMAL_OPS[kind] + P.SAMPLE_OPS[brdf])
                for (kind, brdf), n in inp.hit_mix.items())
    ops = launches * inp.pixels * fold + inp.spp * shade
    nbytes = launches * (inp.pixels * P.FWD_BYTES_PER_PIXEL + P.table_bytes(inp.counts))
    return ops, nbytes + P.STATE_BYTES * inp.pixels * inp.spp
