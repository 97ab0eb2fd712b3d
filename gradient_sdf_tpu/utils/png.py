"""Minimal PNG codec on the standard library (zlib + struct).

Covers what the apps write and the datasets they read: non-interlaced 8- and
16-bit greyscale, grey+alpha, RGB and RGBA, with all five row filters on
read. The writer emits filter type 0 (none). Anything outside that set
(palette images, interlacing, sub-byte depths) raises `UnsupportedPng`, and
callers fall back to another decoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 2: 4, 4: 6}


class UnsupportedPng(ValueError):
    """A valid PNG in a format this codec does not handle."""


def _chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def encode_png(arr: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8/uint16 image shaped [H, W] or [H, W, C] (C in
    1..4)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        bit_depth = 16
    elif arr.dtype == np.uint8:
        bit_depth = 8
    else:
        raise UnsupportedPng(f"dtype {arr.dtype} (need uint8 or uint16)")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPE:
        raise UnsupportedPng(f"shape {arr.shape}")
    h, w, c = arr.shape
    rows = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">")))
    rows = rows.reshape(h, w * c).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    if ftype == 0:
        return line.copy()
    if ftype == 1:  # Sub: running sum along the row, per byte of a pixel
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return line + prev
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    # Average and Paeth depend on the reconstructed left neighbour
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to uint8/uint16 [H, W] (greyscale) or [H, W, C]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, bit_depth, color_type, _, _, interlace = header
    if interlace or bit_depth not in (8, 16) or color_type not in _CHANNELS:
        raise UnsupportedPng(
            f"bit depth {bit_depth}, colour type {color_type}, "
            f"interlace {interlace}")
    c = _CHANNELS[color_type]
    bpp = c * bit_depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w * bpp + 1)
    out = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    if bit_depth == 16:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    img = img.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
