"""The configuration dataclass and its CLI arguments.

Counterpart of ``haskell_path_tracer_tpu/utils/config.py``, with the
reference's values as defaults (800x600, 15 bounces, reseed every 2000
samples).  `algorithm` is "inline" (the reference's parity estimator) or
"physical" (corrected BRDFs, with next-event estimation unless `nee` is
False).  `kernel` picks the backend: "auto" (the algorithm's CUDA
megakernel on a CUDA device, the plain tensor loop elsewhere), "torch"
(the plain loop) or "cuda" (the megakernel; raises off the GPU).
`sampler` is the physical algorithm's RNG: "sfc32", the per-pixel stateful
generator; "threefry" (the JAX package's stateless sampler) is not ported
yet and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RenderConfig:
    width: int = 800
    height: int = 600
    # "inline" or "physical"; the JAX package's "wavefront" is still to
    # come (ROADMAP Queue A).
    algorithm: str = "inline"
    nee: bool = True
    sampler: str = "sfc32"
    kernel: str = "auto"
    bounces: int = 15
    reseed_interval: int = 2000
    russian_roulette: bool = False
    seed: Optional[int] = None
    device: str = "cuda"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    d = RenderConfig()
    parser.add_argument("--width", type=int, default=d.width)
    parser.add_argument("--height", type=int, default=d.height)
    parser.add_argument(
        "--variant",
        choices=["inline", "wavefront", "streams", "physical"],
        default="inline",
        help="rendering algorithm (physical = corrected BRDFs + NEE); "
        "wavefront and streams are not ported yet",
    )
    parser.add_argument(
        "--no-nee", dest="nee", action="store_false", default=True,
        help="disable next-event estimation in physical mode",
    )
    parser.add_argument(
        "--sampler", choices=["sfc32", "threefry"], default=d.sampler,
        help="physical-mode RNG: stateful SFC32 (threefry is not ported yet)",
    )
    parser.add_argument(
        "--kernel", choices=["auto", "torch", "cuda"], default=d.kernel,
        help="backend: auto (the CUDA megakernel on a GPU, plain torch "
        "elsewhere), or force one",
    )
    parser.add_argument(
        "--device", default=d.device,
        help="torch device to render on (default cuda; raises without a GPU)",
    )
    parser.add_argument("--bounces", type=int, default=d.bounces)
    parser.add_argument("--spp", type=int, default=64, help="total samples")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--russian-roulette", action="store_true", default=False
    )
    parser.add_argument("--reseed-interval", type=int, default=d.reseed_interval)


def config_from_args(args: argparse.Namespace) -> RenderConfig:
    algo = "wavefront" if args.variant == "streams" else args.variant
    return RenderConfig(
        width=args.width,
        height=args.height,
        algorithm=algo,
        nee=args.nee,
        sampler=args.sampler,
        kernel=args.kernel,
        bounces=args.bounces,
        reseed_interval=args.reseed_interval,
        russian_roulette=args.russian_roulette,
        seed=args.seed,
        device=args.device,
    )
