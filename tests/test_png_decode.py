"""The stdlib PNG decoder (io/png_io.decode_png) against OpenCV.

The replay datasets are PNGs; decode_png is what reads them where
neither cv2 nor PIL is installed.  It must give the same arrays as
cv2.IMREAD_UNCHANGED on the checked-in orbit_vga frames (8-bit RGB,
16-bit depth) and on synthetic images written with each of the five
PNG row filters.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from disinfect_slam.io.png_io import decode_png, read_image

ORBIT = os.path.join(os.path.dirname(__file__), "..", "datasets", "orbit_vga")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(img: np.ndarray, ftype: int) -> bytes:
    """PNG writer that applies row filter `ftype` to every row (the
    encoder side of the PNG spec's filter definitions)."""
    depth = 16 if img.dtype == np.uint16 else 8
    arr = img[..., None] if img.ndim == 2 else img
    h, w, ch = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = ch * depth // 8
    out = []
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        b = rows[y - 1] if y else np.zeros_like(x)
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][ftype]
        out.append(bytes([ftype]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["0_rgb.png", "0_depth.png"])
def test_decoder_matches_cv2_on_orbit_vga(name):
    cv2 = pytest.importorskip("cv2")
    path = os.path.join(ORBIT, name)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[..., ::-1]  # BGR -> RGB
    with open(path, "rb") as f:
        got = decode_png(f.read())
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# one synthetic image per filter type, covering every channel layout
# and both bit depths across the set
FILTER_CASES = [
    (0, np.uint8, 3),
    (1, np.uint16, 1),
    (2, np.uint8, 4),
    (3, np.uint16, 1),
    (4, np.uint8, 2),
]


@pytest.mark.parametrize("ftype,dtype,ch", FILTER_CASES)
def test_decoder_each_filter_type(ftype, dtype, ch, tmp_path):
    rng = np.random.default_rng(ftype)
    hi = 65535 if dtype == np.uint16 else 255
    shape = (23, 37) if ch == 1 else (23, 37, ch)
    # smooth ramps plus noise: exercises carries in every predictor
    ramp = np.linspace(0, hi, 37)[None, :] * np.linspace(0.2, 1, 23)[:, None]
    if ch > 1:
        ramp = ramp[..., None]
    img = np.clip(ramp + rng.integers(0, hi // 8, shape), 0, hi).astype(dtype)
    data = _encode(img, ftype)
    np.testing.assert_array_equal(decode_png(data), img)
    cv2 = pytest.importorskip("cv2")
    if ch in (1, 3, 4):
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        if ch > 1:
            ref = ref[..., [2, 1, 0, 3][:ch]]
        np.testing.assert_array_equal(decode_png(data), ref)
    # read_image's colour conversion without cv2/PIL matches cv2's
    path = tmp_path / "img.png"
    path.write_bytes(data)
    import disinfect_slam.io.png_io as png_io

    want = read_image(str(path))
    old = png_io._HAS_CV2, png_io._HAS_PIL
    png_io._HAS_CV2 = png_io._HAS_PIL = False
    try:
        got = read_image(str(path))
    finally:
        png_io._HAS_CV2, png_io._HAS_PIL = old
    np.testing.assert_array_equal(got, want)
