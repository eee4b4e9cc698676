"""The port's PNG codec (``utils/png.py``) against Pillow, the codec of
the JAX package's exporter and loader: files written by either read back
with equal pixels through the other, rows under each of the five filters
decode exactly, and a file of a kind the codec does not read raises."""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gail_carla_tpu_torch.utils import png

RNG = np.random.default_rng(0)


def _images():
    """A mask-like image (few levels, flat areas), a noisy RGB image and
    a gray one."""
    mask = np.zeros((48, 40, 3), np.uint8)
    mask[10:30, 5:25, 0] = 255
    mask[::7, :, 2] = 120
    noisy = RNG.integers(0, 256, (33, 17, 3), dtype=np.uint8)
    gray = RNG.integers(0, 256, (21, 30), dtype=np.uint8)
    return {"mask": mask, "noisy": noisy, "gray": gray}


@pytest.mark.parametrize("name", ["mask", "noisy", "gray"])
def test_port_writes_what_pillow_reads(tmp_path, name):
    img = _images()[name]
    path = tmp_path / "a.png"
    png.write_png(path, img)
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, img)
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    np.testing.assert_array_equal(png.read_png(path), rgb)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_port_reads_what_pillow_writes(tmp_path, mode):
    """Pillow's encoder picks row filters adaptively: these files hold
    None, Sub, Up and Paeth rows."""
    imgs = _images()
    src = imgs["gray"] if mode == "L" else imgs["noisy"]
    if mode == "RGBA":
        src = np.concatenate(
            [src, RNG.integers(0, 256, src.shape[:2] + (1,), np.uint8)], 2)
    for name, arr in (("noisy", src), ("mask", imgs["mask"])):
        if mode == "L" and name == "mask":
            arr = imgs["mask"][..., 0]
        elif mode == "RGBA" and name == "mask":
            arr = np.concatenate([arr, np.full(arr.shape[:2] + (1,), 200,
                                               np.uint8)], 2)
        path = tmp_path / f"{name}.png"
        Image.fromarray(arr, mode).save(path)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(png.read_png(path), want)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """An RGB PNG whose row i is stored under filter kinds[i], built by
    hand from the specification's forward filters."""
    h, w, bpp = img.shape
    x = img.astype(np.int32).reshape(h, w * bpp)
    rows = []
    for i, k in enumerate(kinds):
        cur = x[i]
        up = x[i - 1] if i else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][k]
        rows.append(bytes([k]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, -1],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_hand_built_filter_rows_decode_exactly(tmp_path, kind):
    img = RNG.integers(0, 256, (12, 9, 3), dtype=np.uint8)
    kinds = [i % 5 for i in range(12)] if kind < 0 else [kind] * 12
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, kinds))
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_unsupported_files_raise(tmp_path):
    img = _images()["mask"]
    pal = tmp_path / "pal.png"
    Image.fromarray(img).convert("P").save(pal)
    with pytest.raises(png.PngError, match="colour type 3"):
        png.read_png(pal)
    deep = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)).save(deep)
    with pytest.raises(png.PngError, match="bit depth 16"):
        png.read_png(deep)
    # Pillow writes no interlaced file: the same IHDR with Adam7 set
    inter = tmp_path / "inter.png"
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    inter.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                      + png._chunk(b"IDAT", zlib.compress(b"\0" * 80))
                      + png._chunk(b"IEND", b""))
    with pytest.raises(png.PngError, match="interlaced"):
        png.read_png(inter)
    good = tmp_path / "good.png"
    png.write_png(good, img)
    data = bytearray(good.read_bytes())
    data[40] ^= 0xFF    # inside the IDAT payload
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(png.PngError, match="CRC"):
        png.read_png(bad)
    jpg = tmp_path / "a.jpg"
    Image.fromarray(img).save(jpg)
    with pytest.raises(png.PngError, match="not a PNG"):
        png.read_png(jpg)
    with pytest.raises(png.PngError, match="uint8"):
        png.write_png(tmp_path / "f.png", img.astype(np.float32))
