"""The configuration dataclass and its CLI arguments.

Counterpart of ``haskell_path_tracer_tpu/utils/config.py``, with the
reference's values as defaults (800x600, 15 bounces, reseed every 2000
samples).  `kernel` picks the inline backend: "auto" (the CUDA megakernel
on a CUDA device, the plain tensor loop elsewhere), "torch" (the plain
loop) or "cuda" (the megakernel; raises off the GPU).
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
    # Only "inline" is ported; the JAX package's "wavefront" and
    # "physical" are still to come (ROADMAP Queue A).
    algorithm: str = "inline"
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
        help="rendering algorithm; only inline is ported so far",
    )
    parser.add_argument(
        "--kernel", choices=["auto", "torch", "cuda"], default=d.kernel,
        help="inline backend: auto (CUDA megakernel on a GPU, plain torch "
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
        kernel=args.kernel,
        bounces=args.bounces,
        reseed_interval=args.reseed_interval,
        russian_roulette=args.russian_roulette,
        seed=args.seed,
        device=args.device,
    )
