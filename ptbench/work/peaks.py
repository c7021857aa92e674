"""The chip's peaks, the operation constants of the kernels and the bound.

Frozen copy, from chip_smoke.py at commit
46789026a883eb6678717df1b19ed41c83f8556b of this repository (`bound`,
`PEAK_*`, the op and byte constants of the parity, NEE and probe kernels),
with the comments that say how each constant was counted from the CUDA
sources.  The kernels are built with -fmad=false, so every add, sub, mul,
div, sqrt, sin, cos, min, max and int-to-float conversion is one fp32
operation; compares, selects, sign flips and integer work are not counted.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (the data sheet, dense, at its 700 W limit): HBM3 at
# 3.35 TB/s and 67 TFLOP/s of fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# Parity family (csrc/bounce.cuh).  One primitive test of the fold, by kind
# (sphere, plane, box, triangle):
FOLD_OPS = (20, 14, 25, 46)
# A live bounce, whatever it hit: the 3 uniforms (12), the dead test (5),
# the hit point (6), emission, throughput and next origin (18), the
# radiance sum (3):
BOUNCE_OPS = 44
# The winner's normal after the hit point, by kind:
NORMAL_OPS = (13, 0, 27, 0)
# The BRDF sample the winner's kind selects, with the throughput scale:
# matte (69 + 1), glossy (83 + 1), dielectric (38).
SAMPLE_OPS = (70, 84, 38)
# The reverse of a live bounce, without recomputing what the replay
# computed: emission and throughput (48), next ray (6), hit point (15) ...
REVERSE_BOUNCE_OPS = 69
# ... the sample's reverse: matte (87), glossy (175 and the reflection's
# 30), dielectric (the reflected branch, 3 and 30) ...
REVERSE_SAMPLE_OPS = (87, 205, 33)
# ... and the winner's normal, distance and row sums, by kind.
REVERSE_GEOM_OPS = (67, 47, 50, 102)
# Bytes per pixel: rays 24 and rng 16 in, radiance 12 and rng 16 out
# (forward); rays 24, rng 16 and the radiance cotangent 12 in, ray
# cotangents 24 out (backward).  The recorded rng of a pixel at the start of
# a sample, written by the recording forward and read by the per-sample
# backward, is 16 B.
FWD_BYTES_PER_PIXEL = 68
BWD_BYTES_PER_PIXEL = 76
STATE_BYTES = 16

# NEE family (csrc/nee.cuh, csrc/nee_vjp.cuh, csrc/probe.cuh).  The primary
# fold at eps 0, by kind:
PRIMARY_FOLD_OPS = (19, 14, 25, 46)
# The dual fold of a live bounce (the BSDF ray's nearest hit and the shadow
# ray's any-hit from one shade point), by kind:
DUAL_FOLD_OPS = (31, 20, 44, 76)
# A live bounce, whatever it hit: the 6 uniforms (12), the dead test (5),
# the hit point (6), the next throughput (3) and the cheapest sample, the
# mirror reflection (12); with emitters, the light choice (3) and the
# cheapest light sample, the cone with its distance (74).
NEE_BOUNCE_OPS, NEE_LIGHT_OPS = 38, 77
# The reverse of a live NEE bounce (a matte sphere winner with a sphere
# light sample): distance and normal again (38), the light sample again
# (77), the NEE term's reverse (50), the cone's (110), the cosine sample's
# (44), the normal's (32), the hit point's (15), the distance's (44) and
# the throughput's (6).
NEE_REVERSE_OPS = 416
# Bytes per pixel: rays 24 and rng 16 in, radiance 12 and rng 16 out (the
# NEE kernel); rays 24 in, t and prim 8 out (the probe); the NEE backward's
# rays 24, rng 16 and radiance cotangent 12 in, ray cotangents 24 out; in
# the sorted frame the lane order and the probe's (t0, prim0), 12 more.
NEE_BYTES_PER_PIXEL, PROBE_BYTES_PER_RAY = 68, 32
NEE_BWD_BYTES_PER_PIXEL, SORTED_BYTES_PER_PIXEL = 76, 12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 rate, in seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)


def fold_floats(counts) -> int:
    """Floats of the NEE kernels' fold table: 4 per sphere, 8 per plane."""
    spheres, planes = counts
    return 4 * spheres + 8 * planes


def table_bytes(counts, lights: int = 0) -> int:
    """Bytes of the tables a kernel reads once: the fold rows, a 12-float
    payload row per primitive and a 16-float row per emitter."""
    return 4 * (fold_floats(counts) + 12 * sum(counts) + 16 * max(lights, 1))


def primary_fold_ops(counts) -> int:
    return sum(n * f for n, f in zip(counts, PRIMARY_FOLD_OPS))
