"""The port's OpenEXR output against the JAX package's reader and writer.

`haskell_path_tracer_torch/utils/image.py` keeps its own copy of the JAX
package's `write_exr`/`read_exr`; these tests hold the two copies to each
other byte for value.  Tolerance: none.  The radiance must come back
bit-equal (after a round to half where the file stores half floats), for
each compression (none, zips, zip) and each pixel type.
"""

import numpy as np
import pytest

from haskell_path_tracer_tpu.utils import image as JI
from haskell_path_tracer_torch.utils import image as TI

COMPRESSIONS = ("none", "zips", "zip")


def _radiance(seed=0, h=37, w=53):
    """Unclamped HDR radiance with negative lanes (the unclamped matte BRDF
    gives them) and a few large values, odd sizes for a ragged zip block."""
    rng = np.random.default_rng(seed)
    img = rng.normal(2.0, 5.0, size=(h, w, 3)).astype(np.float32)
    img[::7, ::5] *= 300.0
    return img


def _stored(img, half):
    return img.astype(np.float16).astype(np.float32) if half else img


def test_save_render_exr_is_raw_flipped_radiance(tmp_path):
    """`save_render("y.exr", img)` writes OpenEXR, not PNG bytes: the raw
    radiance, flipped at the display boundary as the JAX package writes
    it, which the JAX package's reader reads back bit-equal."""
    img = _radiance()
    path = str(tmp_path / "y.exr")
    assert TI.save_render(path, img) == path
    with open(path, "rb") as f:
        assert f.read(4) == b"\x76\x2f\x31\x01"  # OpenEXR magic 20000630
    np.testing.assert_array_equal(JI.read_exr(path), img[::-1])
    np.testing.assert_array_equal(TI.read_exr(path), img[::-1])


def test_save_render_exr_matches_jax_file(tmp_path):
    """The port's `save_render` and the JAX package's write the same bytes
    for an `.exr` path."""
    img = _radiance(1)
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    TI.save_render(a, img)
    JI.write_exr(b, np.asarray(img)[::-1])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("half", [False, True], ids=["float32", "half"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_port_exr_read_by_jax(tmp_path, compression, half):
    """The port's writer, each compression and pixel type, read back by the
    JAX package's `read_exr` bit-equal to what the file stores."""
    img = _radiance(2)
    path = str(tmp_path / "port.exr")
    TI.write_exr(path, img, compression=compression, half=half)
    np.testing.assert_array_equal(JI.read_exr(path), _stored(img, half))


@pytest.mark.parametrize("half", [False, True], ids=["float32", "half"])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_jax_exr_read_by_port(tmp_path, compression, half):
    """The JAX package's writer, each compression and pixel type, read back
    by the port's `read_exr` bit-equal to what the file stores."""
    img = _radiance(3)
    path = str(tmp_path / "jax.exr")
    JI.write_exr(path, img, compression=compression, half=half)
    np.testing.assert_array_equal(TI.read_exr(path), _stored(img, half))


def test_save_render_png_unchanged(tmp_path):
    """Other suffixes still tonemap: a PNG path gets PNG bytes."""
    path = str(tmp_path / "y.png")
    TI.save_render(path, _radiance(4))
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
