"""Image output: tonemap and PNG/PPM writers, in numpy.

Vendored from ``haskell_path_tracer_tpu/utils/image.py`` (that package
cannot be imported without JAX).  The native C++ tonemap it can use is
not wired here yet (ROADMAP Queue A #13).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(image: np.ndarray, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
    """HDR radiance -> display: exposure scale, Reinhard, gamma. uint8 [H,W,3]."""
    x = np.asarray(image, np.float32) * np.float32(exposure)
    x = x / (1.0 + x)  # Reinhard
    x = np.clip(x, 0.0, 1.0) ** np.float32(1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def encode_png(rgb8: np.ndarray) -> bytes:
    """Minimal dependency-free PNG encoder (8-bit RGB) -> bytes."""
    h, w, c = rgb8.shape
    if c != 3 or rgb8.dtype != np.uint8:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb8.dtype} {rgb8.shape}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    # filter type 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))


def write_ppm(path: str, rgb8: np.ndarray) -> None:
    """Trivial PPM writer (debugging)."""
    h, w, _ = rgb8.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb8.tobytes())


def save_render(path: str, image, exposure: float = 1.0, gamma: float = 2.2):
    """Tonemap a normalized radiance image and write PNG (or PPM by suffix).

    The accumulator's row 0 carries the downward-tilted primary rays; the
    reference showed that array through an OpenGL texture whose row 0 is
    at the bottom of the window, while image files put row 0 at the top —
    so flip vertically here, at the display boundary."""
    img = np.asarray(image)[::-1]
    rgb8 = tonemap(img, exposure=exposure, gamma=gamma)
    if path.endswith(".ppm"):
        write_ppm(path, rgb8)
    else:
        write_png(path, rgb8)
    return path
