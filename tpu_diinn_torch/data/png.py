"""PNG reader and writer on stdlib ``zlib`` and numpy.

Counterpart of the JAX pipeline's ``datasets._read_image`` (PIL), for the
files this repository carries: 8-bit, non-interlaced RGB or RGBA (alpha is
dropped, as PIL's ``convert("RGB")`` does). Any other PNG raises with the
file's name. ``write_png`` writes 8-bit RGB with every row unfiltered
(filter type 0), the counterpart of the JAX demo's PIL save.

Unfiltering is vectorised over anti-diagonals: every PNG filter predicts a
pixel from its left, upper and upper-left neighbours only, so all pixels on
one diagonal ``y + x = d`` are independent once diagonals ``d-1`` and
``d-2`` are done. That is H + W - 1 numpy steps per image, whatever mix of
the five filter types the rows use.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}          # colour type -> samples per pixel


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo per-row PNG filters; raw is (h, 1 + w*bpp) uint8."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # one zero row on top and one zero column on the left stand for the
    # "outside the image" neighbours every filter reads as 0
    out = np.zeros((h + 1, w + 1, bpp), dtype=np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]          # left
        b = out[ys, xs + 1]          # up
        c = out[ys, xs]              # up-left
        ft = ftype[ys][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode ``path`` to an (H, W, 3) uint8 RGB array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _comp, _filt, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); only 8-bit non-interlaced "
            f"RGB/RGBA is read")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {h * (1 + w * bpp)}")
    img = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    return np.ascontiguousarray(img[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB array as an 8-bit PNG, every row with
    filter type 0, the data deflated at zlib level 6 (PIL's default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: write_png takes (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + w * 3), np.uint8)      # column 0: filter type 0
    raw[:, 1:] = img.reshape(h, w * 3)
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
