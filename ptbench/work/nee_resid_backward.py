"""#5r, the NEE backward in its residual mode: a lower bound on the work of
one unit.

Counted: the reverse of the first bounce of every sample whose primary ray
hits with that bounce's least forward work (`peaks.NEE_REVERSE_OPS` +
`peaks.NEE_BOUNCE_OPS`), the residual word it reads (4 B), and per launch
the pixels' bytes and the tables read and their cotangents written.  Left
out: every later bounce.
"""

from . import peaks as P

MATCH = r"(?<![A-Za-z0-9_])nee_vjp_resid_kernel<"


def work(inp, launches: float):
    ops = inp.spp * inp.hits * (P.NEE_REVERSE_OPS + P.NEE_BOUNCE_OPS)
    nbytes = launches * (inp.pixels * P.NEE_BWD_BYTES_PER_PIXEL
                         + 2 * P.table_bytes(inp.counts, inp.lights))
    return ops, nbytes + 4 * inp.spp * inp.hits
