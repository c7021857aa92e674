"""Checkpoint / resume of progressive render state.

The format of ``haskell_path_tracer_tpu/utils/checkpoint.py``: one .npz
written by atomic rename, with keys version, color, rng (uint32 on disk)
and iterations, plus extra_* arrays — so a checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..models.convert import accumulator_from_numpy, accumulator_to_numpy
from ..models.objects import Accumulator

FORMAT_VERSION = 1


def save_accumulator(path: str, acc: Accumulator, extra: dict | None = None) -> None:
    """Atomically write the accumulator (+ optional extra arrays)."""
    arrays = {"version": np.int32(FORMAT_VERSION), **accumulator_to_numpy(acc)}
    for k, v in (extra or {}).items():
        arrays["extra_" + k] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_accumulator(path: str, device):
    """Returns (Accumulator on `device`, extra dict)."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version}, expected {FORMAT_VERSION}")
        acc = accumulator_from_numpy(z, device)
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
    return acc, extra
