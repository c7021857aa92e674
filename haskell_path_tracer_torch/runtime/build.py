"""Build the port's native output library (g++ -> a shared library).

Counterpart of ``haskell_path_tracer_tpu/runtime/build.py`` for the
port's own source, ``csrc/ptru_native.cpp`` (the tonemap and the PNG
writer).  The library is built at first use, never at import, into the
gitignored ``_build/`` beside the package (never next to a source), and is
named by a hash of the source and the flags, so a stale build is never
loaded.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "ptru_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_CXX = os.environ.get("CXX", "g++")
# -ffp-contract=off: g++ contracts a*b+c into an FMA by default at -O2, and
# the output must evaluate plain IEEE f32, as numpy does, to stay within an
# LSB of utils/image.py:tonemap (the JAX package's build keeps the flag for
# the same reason).
FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz",)


class BuildError(RuntimeError):
    pass


def library_file() -> str:
    """The path of the built library: a hash of the source and the flags."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join((_CXX, *FLAGS, *LIBS)).encode())
    return os.path.join(BUILD_DIR, f"libptru_native-{digest.hexdigest()[:16]}.so")


def library_path() -> str:
    """The built library's path, compiling it first if it is not there.
    Raises `BuildError` when g++ is missing or fails (zlib absent, say)."""
    path = library_file()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a temporary name and rename it into place, so a concurrent
    # loader never opens a half-written file.
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_CXX, *FLAGS, SOURCE, "-o", tmp, *LIBS]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise BuildError(f"native build failed to run: {e}") from e
        if proc.returncode != 0:
            raise BuildError(f"native build failed:\n$ {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
