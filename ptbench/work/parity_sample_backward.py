"""#2s, the parity backward with one thread per (pixel, sample): a lower
bound on the work of one unit.

Counted: for every sample whose primary ray hits, the reverse of its first
bounce by its winner's kind and BRDF (`peaks.REVERSE_BOUNCE_OPS`,
`REVERSE_SAMPLE_OPS`, `REVERSE_GEOM_OPS`); per launch the pixels' bytes,
the recorded rng of every sample (16 B) and the tables read and their
cotangents written.  Left out: the replay of the forward and every later
bounce.
"""

from . import peaks as P

MATCH = r"(?<![A-Za-z0-9_])megakernel_vjp<\s*\w+,\s*\w+,\s*\w+,\s*true\s*>"


def work(inp, launches: float):
    ops = inp.spp * sum(
        n * (P.REVERSE_BOUNCE_OPS + P.REVERSE_SAMPLE_OPS[brdf] + P.REVERSE_GEOM_OPS[kind])
        for (kind, brdf), n in inp.hit_mix.items())
    nbytes = launches * (inp.pixels * P.BWD_BYTES_PER_PIXEL + 2 * P.table_bytes(inp.counts))
    return ops, nbytes + P.STATE_BYTES * inp.pixels * inp.spp
