"""utils/png: the stdlib PNG codec the apps write and read with."""

import io
import struct
import zlib

import numpy as np
import pytest

from gradient_sdf_tpu.data import loaders
from gradient_sdf_tpu.utils import png

RNG = np.random.RandomState(3)
IMAGES = {
    "grey16": (RNG.rand(14, 21) * 65535).astype(np.uint16),
    "grey8": (RNG.rand(14, 21) * 255).astype(np.uint8),
    "rgb8": (RNG.rand(14, 21, 3) * 255).astype(np.uint8),
    "rgba8": (RNG.rand(14, 21, 4) * 255).astype(np.uint8),
}


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_round_trip_bit_equal_to_pil(kind):
    img = IMAGES[kind]
    data = png.encode_png(img)
    out = png.decode_png(data)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)
    try:
        from PIL import Image
    except ImportError:
        return
    # PIL decodes what we wrote, and we decode what PIL wrote, bit-equal
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)


def _filter_row(ftype, line, prev, bpp):
    """Reference PNG row filter (spec section 9.2), byte by byte."""
    out = []
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out.append((x - pred) % 256)
    return bytes([ftype] + out)


def test_decodes_every_row_filter():
    """A 16-bit image whose rows cycle through all five filter types (large
    and coarse enough that Paeth's predictor ties occur)."""
    img = (RNG.randint(0, 4, (40, 64)) * 21845).astype(np.uint16)
    h, w = img.shape
    rows = img.astype(">u2").reshape(h, w).view(np.uint8)
    prev = [0] * rows.shape[1]
    raw = b""
    for y in range(h):
        line = [int(x) for x in rows[y]]
        raw += _filter_row(y % 5, line, prev, bpp=2)
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(raw))
            + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_unsupported_formats_raise_and_loader_falls_back(tmp_path):
    """Interlaced and palette PNGs are outside the codec's set; the loader
    then hands them to PIL."""
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0)  # palette
    data = b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr)
    with pytest.raises(png.UnsupportedPng):
        png.decode_png(data)
    with pytest.raises(png.UnsupportedPng):
        png.encode_png(np.zeros((2, 2), np.float32))
    Image = pytest.importorskip("PIL.Image")
    img = IMAGES["rgb8"]
    path = str(tmp_path / "palette.png")
    Image.fromarray(img).convert("P").save(path)
    with pytest.raises(png.UnsupportedPng):
        png.read_png(path)
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(loaders._imread(path), ref)


def test_make_synth_frames_read_back_through_loader(tmp_path):
    """make_synth's writers and the loader's reader agree on depth (mm) and
    colour (1/255) quantisation."""
    from gradient_sdf_tpu.apps import make_synth

    depth = np.linspace(0.0, 3.2, 12 * 9, dtype=np.float32).reshape(9, 12)
    color = RNG.rand(9, 12, 3).astype(np.float32)
    make_synth.write_png16(str(tmp_path / "d.png"), depth)
    make_synth.write_png8(str(tmp_path / "c.png"), color)
    d = loaders.load_depth_png(str(tmp_path / "d.png"), 1e-3)
    c = loaders.load_color_png(str(tmp_path / "c.png"))
    np.testing.assert_allclose(d, np.round(depth * 1000) / 1000, atol=1e-6)
    np.testing.assert_allclose(c, np.floor(color * 255) / 255, atol=1e-6)
