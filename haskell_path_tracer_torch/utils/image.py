"""Image output: tonemap, PNG/PPM writers and an OpenEXR writer and
reader, in numpy and zlib.

Vendored from ``haskell_path_tracer_tpu/utils/image.py`` (that package
cannot be imported without JAX).  The native C++ tonemap and PNG encoder
it can use are not wired here yet (ROADMAP Queue A #6).
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


def _exr_zip_pack(raw: bytes) -> bytes:
    """OpenEXR's zip pre-filter and deflate (ImfZip.cpp semantics): split
    the byte stream into its even and odd bytes, delta-encode with a +128
    bias, then zlib."""
    a = np.frombuffer(raw, np.uint8)
    n = a.size
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = a[0::2]
    t[half:] = a[1::2]
    d = t.astype(np.int16)
    d[1:] -= t[:-1].astype(np.int16) - 128
    return zlib.compress(d.astype(np.uint8).tobytes())


def _exr_zip_unpack(packed: bytes, raw_size: int) -> bytes:
    """Inverse of `_exr_zip_pack`."""
    t = np.frombuffer(zlib.decompress(packed), np.uint8)
    if t.size != raw_size:
        raise ValueError(f"EXR block inflates to {t.size} bytes, expected {raw_size}")
    # Undo the delta: out[i] = out[i-1] + in[i] - 128 (mod 256).
    u = t.astype(np.int64)
    u[1:] -= 128
    t = (np.cumsum(u) % 256).astype(np.uint8)
    half = (raw_size + 1) // 2
    a = np.empty(raw_size, np.uint8)
    a[0::2] = t[:half]
    a[1::2] = t[half:]
    return a.tobytes()


# EXR compression codes, scanlines per block, bytes per pixel by type.
_EXR_NONE, _EXR_ZIPS, _EXR_ZIP = 0, 2, 3
_EXR_BLOCK_LINES = {_EXR_NONE: 1, _EXR_ZIPS: 1, _EXR_ZIP: 16}
_EXR_PIXEL_SIZE = {1: 2, 2: 4}  # HALF, FLOAT


def write_exr(path: str, image: np.ndarray, compression: str = "zip", half: bool = False) -> None:
    """OpenEXR 2.0 writer: single part, scanline, B/G/R channels.

    `compression`: "none", "zips" (per-line deflate) or "zip" (16-line
    blocks, the OpenEXR default).  `half=True` writes IEEE half-float
    channels, False full float32.  The radiance goes to disk unclamped."""
    comp = {"none": _EXR_NONE, "zips": _EXR_ZIPS, "zip": _EXR_ZIP}[compression]
    ptype = 1 if half else 2
    img = np.asarray(image, np.float32).astype(np.float16 if half else np.float32)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")

    def attr(name: bytes, typ: bytes, data: bytes) -> bytes:
        return name + b"\0" + typ + b"\0" + struct.pack("<I", len(data)) + data

    def chan(name: bytes) -> bytes:
        # name, pixel_type, pLinear + 3 reserved, x/y sampling
        return name + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<II", 20000630, 2)  # magic, version 2 without flags
        + attr(b"channels", b"chlist", chan(b"B") + chan(b"G") + chan(b"R") + b"\0")
        + attr(b"compression", b"compression", bytes([comp]))
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"  # end of header
    )
    lines = _EXR_BLOCK_LINES[comp]
    blocks = []
    for y0 in range(0, h, lines):
        # Per scanline, channels in header (alphabetical) order: B, G, R.
        raw = b"".join(np.ascontiguousarray(img[y, :, ch]).tobytes()
                       for y in range(y0, min(y0 + lines, h)) for ch in (2, 1, 0))
        data = raw if comp == _EXR_NONE else _exr_zip_pack(raw)
        blocks.append((y0, raw if len(data) >= len(raw) else data))  # OpenEXR: raw if not smaller

    offsets, pos = [], len(header) + 8 * len(blocks)
    for _, data in blocks:
        offsets.append(pos)
        pos += 8 + len(data)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<%dQ" % len(blocks), *offsets))
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def read_exr(path: str) -> np.ndarray:
    """Single-part scanline EXR reader: none, zips or zip compression, half
    or float channels in any header order.  Returns [H, W, 3] f32 (R, G,
    B; missing channels read as 0)."""
    with open(path, "rb") as f:
        blob = f.read()
    magic, _version = struct.unpack("<II", blob[:8])
    if magic != 20000630:
        raise ValueError(f"{path} is not an EXR file")
    pos, attrs = 8, {}
    while blob[pos] != 0:
        end = blob.index(b"\0", pos)
        name = blob[pos:end].decode()
        pos = blob.index(b"\0", end + 1) + 1  # skip the type name
        (size,) = struct.unpack("<I", blob[pos:pos + 4])
        attrs[name] = blob[pos + 4:pos + 4 + size]
        pos += 4 + size
    pos += 1  # header terminator
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][0]
    if comp not in _EXR_BLOCK_LINES:
        raise ValueError(f"unsupported EXR compression {comp}")

    # The channel list: (name, pixel_type) in file order.
    chans, cpos, cl = [], 0, attrs["channels"]
    while cl[cpos] != 0:
        cend = cl.index(b"\0", cpos)
        ptype = struct.unpack("<i", cl[cend + 1:cend + 5])[0]
        if ptype not in _EXR_PIXEL_SIZE:
            raise ValueError(f"unsupported EXR pixel type {ptype}")
        chans.append((cl[cpos:cend].decode(), ptype))
        cpos = cend + 1 + 16
    line_bytes = sum(w * _EXR_PIXEL_SIZE[t] for _, t in chans)

    lines = _EXR_BLOCK_LINES[comp]
    n_blocks = -(-h // lines)
    pos += 8 * n_blocks  # offset table
    img = np.zeros((h, w, 3), np.float32)
    rgb = {"R": 0, "G": 1, "B": 2}
    for _ in range(n_blocks):
        by, size = struct.unpack("<ii", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + size]
        pos += 8 + size
        n_lines = min(lines, h - (by - y0))
        raw_size = line_bytes * n_lines
        raw = data if comp == _EXR_NONE or size == raw_size else _exr_zip_unpack(data, raw_size)
        off = 0
        for li in range(n_lines):
            for cname, ptype in chans:
                nb = w * _EXR_PIXEL_SIZE[ptype]
                if cname in rgb:
                    dt = np.float16 if ptype == 1 else np.float32
                    img[by - y0 + li, :, rgb[cname]] = np.frombuffer(raw[off:off + nb], dt)
                off += nb
    return img


def write_ppm(path: str, rgb8: np.ndarray) -> None:
    """Trivial PPM writer (debugging)."""
    h, w, _ = rgb8.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb8.tobytes())


def save_render(path: str, image, exposure: float = 1.0, gamma: float = 2.2):
    """Write a normalized radiance image by suffix: `.exr` the raw,
    unclamped radiance as OpenEXR (no tonemap), `.ppm` and anything else
    tonemapped to PPM or PNG.

    The accumulator's row 0 carries the downward-tilted primary rays; the
    reference showed that array through an OpenGL texture whose row 0 is
    at the bottom of the window, while image files put row 0 at the top —
    so flip vertically here, at the display boundary."""
    img = np.asarray(image)[::-1]
    if path.endswith(".exr"):
        write_exr(path, img)
        return path
    rgb8 = tonemap(img, exposure=exposure, gamma=gamma)
    if path.endswith(".ppm"):
        write_ppm(path, rgb8)
    else:
        write_png(path, rgb8)
    return path
