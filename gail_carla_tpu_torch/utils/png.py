"""The port's PNG codec, on ``zlib`` from the standard library.

The demo-file format (``gail_experts/`` trees, carla_exp.py:23-80) is
PNG. The port reads and writes it with this module alone, so it needs
no imaging package on either machine.

- ``write_png`` writes 8-bit grayscale (H, W) or RGB (H, W, 3) arrays,
  every row under filter 0 (None), compressed at ``COMPRESS_LEVEL``.
- ``read_png`` reads 8-bit, non-interlaced files of colour type 0
  (grayscale), 2 (RGB) or 6 (RGBA) under any of the five row filters and
  returns (H, W, 3) uint8: gray is repeated over three channels and alpha
  dropped, as ``Image.convert("RGB")`` does. Anything else (palettes,
  other bit depths, interlacing, a bad CRC, a truncated file) raises
  ``PngError`` naming what it lacks.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# zlib level of the writer: the masks and cameras are large flat areas,
# which level 1 already compresses well, at a third of level 6's time
COMPRESS_LEVEL = 1
# colour type -> channels of a supported file
CHANNELS = {0: 1, 2: 3, 6: 4}


class PngError(ValueError):
    """A file this codec does not read."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path, arr) -> None:
    """Write an 8-bit (H, W) gray or (H, W, 3) RGB array as a PNG file."""
    a = np.ascontiguousarray(arr)
    if a.dtype != np.uint8:
        raise PngError(f"write_png takes uint8 arrays, got {a.dtype}")
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        color = 2
    else:
        raise PngError(f"write_png takes (H, W) or (H, W, 3), got "
                       f"{a.shape}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + a[0].size), np.uint8)   # filter byte 0 per row
    rows[:, 1:] = a.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(),
                                                COMPRESS_LEVEL))
                + _chunk(b"IEND", b""))


def _chunks(data: bytes, path):
    """(kind, payload) of every chunk, each CRC checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise PngError(f"{path}: truncated chunk header")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n or pos + 12 + n > len(data):
            raise PngError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise PngError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, payload
        pos += 12 + n


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + w*bpp) scanlines: (h, w, bpp).

    Filters 1-4 predict a byte from its left, upper and upper-left
    neighbours (Sub, Up, Average, Paeth), so every pixel of one
    anti-diagonal depends only on earlier ones: they are decoded one
    anti-diagonal at a time, each in one vector step."""
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise PngError(f"unknown row filter {int(kinds.max())}")
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if not kinds.any():
        return filt.astype(np.uint8)
    # recon with a zero row above and a zero column to the left
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a = out[r + 1, x]        # left
        b = out[r, x + 1]        # up
        c = out[r, x]            # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        k = kinds[r][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit, non-interlaced gray, RGB or RGBA
    PNG file; raises ``PngError`` on any other file."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise PngError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise PngError(f"{path}: no IHDR chunk")
    w, h, depth, color, comp, filt_method, interlace = header
    if depth != 8:
        raise PngError(f"{path}: bit depth {depth}; only 8 is read")
    if color not in CHANNELS:
        raise PngError(f"{path}: colour type {color}; only 0 (gray), "
                       f"2 (RGB) and 6 (RGBA) are read")
    if comp != 0 or filt_method != 0:
        raise PngError(f"{path}: unknown compression or filter method")
    if interlace != 0:
        raise PngError(f"{path}: interlaced; only non-interlaced is read")
    bpp = CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"{path}: corrupt image data ({e})") from None
    if len(raw) != h * (1 + w * bpp):
        raise PngError(f"{path}: image data of {len(raw)} bytes, "
                       f"expected {h * (1 + w * bpp)}")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp),
                   h, w, bpp)
    if bpp == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
