"""Image I/O: cv2, then PIL, then a stdlib PNG codec.

Handles the formats the reference pipeline reads/writes: 8-bit RGB PNGs,
16-bit depth/probability PNGs (offline.cc:64-83), and RGBA render dumps.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - environment probing
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

try:  # pragma: no cover
    from PIL import Image

    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def read_image(path: str, unchanged: bool = False) -> np.ndarray:
    """Read an image. unchanged=True preserves 16-bit single channel
    (cv2.IMREAD_UNCHANGED semantics). RGB images return channels in RGB
    order.  cv2 or PIL are used when installed; PNGs decode without
    either (decode_png)."""
    if _HAS_CV2:
        flag = cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3 and img.shape[2] >= 3:
            img = img[..., [2, 1, 0] + list(range(3, img.shape[2]))]
        return img
    if _HAS_PIL:
        img = Image.open(path)
        if not unchanged and img.mode not in ("RGB", "RGBA"):
            img = img.convert("RGB")
        return np.asarray(img)
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if unchanged:
        return img
    # IMREAD_COLOR: 8-bit, three channels
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 2:  # gray + alpha
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> channels (gray, RGB, gray+alpha, RGBA; no palette)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    """Stdlib (zlib + numpy) PNG decoder: 8- or 16-bit gray, gray+alpha,
    RGB and RGBA, non-interlaced, every filter type.  Returns [H, W] for
    one channel, else [H, W, C], as uint8 or uint16 (RGB order)."""
    import struct
    import zlib

    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace})"
        )
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8  # bytes per pixel: the filters' left distance
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    ftype, filt = raw[:, 0], raw[:, 1:]
    out = np.empty((h, stride), np.uint8)
    if np.any(ftype > 4):
        raise ValueError("corrupt PNG: unknown filter type")
    # None and Sub need no other row: all such rows at once.  Sub is a
    # cumulative sum mod 256 along each byte lane of the pixel.
    none = ftype == 0
    out[none] = filt[none]
    sub = ftype == 1
    if sub.any():
        lanes = filt[sub].reshape(-1, w, bpp)
        out[sub] = np.cumsum(lanes, axis=1, dtype=np.uint8).reshape(-1, stride)
    # Up, Average and Paeth read the row above, in order
    zero = np.zeros(stride, np.uint8)
    for y in np.flatnonzero(ftype >= 2):
        prior = out[y - 1] if y else zero
        if ftype[y] == 2:
            out[y] = filt[y] + prior
        else:
            out[y] = _unfilter_row(int(ftype[y]), filt[y], prior, bpp)
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = out.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _unfilter_row(ftype: int, filt, prior, bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4): each pixel depends on the one to its
    left, so this walks the row a pixel (bpp byte lanes) at a time."""
    row = np.zeros(filt.shape[0], np.int32)
    f = filt.astype(np.int32)
    b = prior.astype(np.int32)
    for x in range(0, f.shape[0], bpp):
        s = slice(x, x + bpp)
        a = row[x - bpp:x] if x else np.zeros(bpp, np.int32)
        if ftype == 3:
            pred = (a + b[s]) >> 1
        else:
            c = b[x - bpp:x] if x else np.zeros(bpp, np.int32)
            p = a + b[s] - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b[s]), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b[s], c))
        row[s] = (f[s] + pred) & 0xFF
    return row.astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """Encode u8 gray/RGB/RGBA to in-memory PNG bytes (for HTTP serving,
    the browser-viewer analogue of GLImage8UC4::LoadCuda->Draw,
    reference utils/gl/image.h:27-56)."""
    img = np.ascontiguousarray(img)
    if _HAS_CV2:
        out = img
        if img.ndim == 3 and img.shape[2] >= 3:
            out = np.ascontiguousarray(img[..., [2, 1, 0] + list(range(3, img.shape[2]))])
        ok, buf = cv2.imencode(".png", out)
        if not ok:
            raise IOError("cv2.imencode failed")
        return buf.tobytes()
    if _HAS_PIL:
        import io

        b = io.BytesIO()
        Image.fromarray(img).save(b, format="PNG")
        return b.getvalue()
    return _encode_png_stdlib(img)


def _encode_png_stdlib(img: np.ndarray) -> bytes:
    """Minimal pure-stdlib PNG encoder (u8 gray/RGB/RGBA, u16 gray),
    used only when neither cv2 nor PIL is importable."""
    import struct
    import zlib

    if img.dtype == np.uint16 and img.ndim == 2:
        depth, color_type, arr = 16, 0, img.astype(">u2")[..., None]
    elif img.dtype != np.uint8:
        raise ValueError("stdlib PNG encoder supports uint8, or uint16 gray")
    elif img.ndim == 2:
        depth, color_type, arr = 8, 0, img[..., None]
    elif img.shape[2] == 3:
        depth, color_type, arr = 8, 2, img
    elif img.shape[2] == 4:
        depth, color_type, arr = 8, 6, img
    else:
        raise ValueError(f"unsupported channel count {img.shape}")
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    return (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_image(path: str, img: np.ndarray) -> None:
    """Write an image; accepts u8 RGB/RGBA/gray or u16 gray."""
    img = np.asarray(img)
    if _HAS_CV2:
        out = img
        if img.ndim == 3 and img.shape[2] >= 3:
            out = img[..., [2, 1, 0] + list(range(3, img.shape[2]))]
        if not cv2.imwrite(path, out):
            raise IOError(f"failed to write {path}")
        return
    if _HAS_PIL:
        Image.fromarray(img).save(path)
        return
    with open(path, "wb") as f:
        f.write(_encode_png_stdlib(np.ascontiguousarray(img)))
