"""ctypes bindings of the port's native output library
(``csrc/ptru_native.cpp``, built by `runtime/build.py`).

Counterpart of the output part of ``haskell_path_tracer_tpu/runtime/
native.py``: `tonemap_rgb8` and `write_png`, which `utils/image.py:
save_render` takes when the library loads.  The tonemap runs on the host
in both packages; `available()` is the capability gate, as there: without
g++ or zlib the numpy tonemap and encoder in `utils/image.py` do the same
work.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import build

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None (and the
    reason in `load_error()`) if it cannot be."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build.library_path())
    except (build.BuildError, OSError) as e:
        _load_error = str(e)
        return None
    lib.ptru_tonemap_rgb8.argtypes = [_f32p, _u8p, ctypes.c_int64, ctypes.c_float, ctypes.c_float]
    lib.ptru_tonemap_rgb8.restype = None
    lib.ptru_write_png.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int, ctypes.c_int]
    lib.ptru_write_png.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _load_error


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native output library is not available: {_load_error}")
    return lib


def tonemap_rgb8(image: np.ndarray, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
    """Native tonemap: HDR [..., 3] f32 -> LDR [..., 3] u8."""
    lib = _library()
    flat = np.ascontiguousarray(image, np.float32)
    if flat.shape[-1] != 3:
        raise ValueError(f"expected [..., 3], got {flat.shape}")
    out = np.empty(flat.shape, np.uint8)
    lib.ptru_tonemap_rgb8(flat.reshape(-1, 3), out.reshape(-1, 3), flat.size // 3,
                          exposure, 1.0 / gamma)
    return out


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write uint8 [H, W, 3] as an 8-bit RGB PNG."""
    lib = _library()
    if rgb8.ndim != 3 or rgb8.shape[2] != 3 or rgb8.dtype != np.uint8:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb8.dtype} {rgb8.shape}")
    h, w, _ = rgb8.shape
    rc = lib.ptru_write_png(path.encode(), np.ascontiguousarray(rgb8), w, h)
    if rc != 0:
        raise OSError(f"ptru_write_png failed with code {rc} for {path!r}")
