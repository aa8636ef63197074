"""PNG files without Pillow: the command line's image codec.

``write_png`` writes an (H, W, 3) uint8 image as an 8-bit RGB PNG (colour
type 2, every row unfiltered, one zlib stream).  ``read_png`` reads the
non-interlaced 8-bit files of colour types 0 (grey), 2 (RGB), 3 (palette,
without ``tRNS``), 4 (grey + alpha) and 6 (RGBA), each row under any of
the five filters, and returns (H, W, C) uint8 with C = 1, 3 (RGB and
palette, expanded), 2 or 4.  Any other file raises ``ValueError`` naming
Pillow as the way to read it.

``to_tensor`` and ``to_grey`` give what ``utils/image.py:pil_to_tensor``
gives for ``Image.open(path)`` (and ``.convert("L")``) at the image's own
size: Pillow's RGBA conversion, fully transparent pixels zeroed, then the
value range, bit for bit; the grey rule is Pillow's
``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``.  Stdlib ``zlib`` and
``struct`` and numpy only; the value arithmetic is ``utils/image.py``'s
``rgba_to_range``, the one ``pil_to_tensor`` runs.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .image import rgba_to_range

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unsupported(path, what: str) -> ValueError:
    return ValueError(f"{path}: {what}; read it with Pillow "
                      "(utils/image.py:pil_to_tensor)")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str | Path, image) -> Path:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG at ``path``."""
    a = np.ascontiguousarray(image)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {a.shape} {a.dtype}")
    H, W, _ = a.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), a.reshape(H, W * 3)], axis=1)
    png = (SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    path = Path(path)
    path.write_bytes(png)
    return path


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, H: int, stride: int, bpp: int, path) -> np.ndarray:
    """The filtered scanlines -> (H, stride) uint8."""
    if len(raw) < H * (stride + 1):
        raise ValueError(f"{path}: image data ends early")
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        line = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        ftype, cur = line[0], np.frombuffer(line, np.uint8, offset=1)
        if ftype == 0:
            row = cur.copy()
        elif ftype == 2:  # Up
            row = cur + prior
        elif ftype in (1, 3, 4):
            row, up = bytearray(cur.tobytes()), prior.tobytes()
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                if ftype == 1:  # Sub
                    pred = left
                elif ftype == 3:  # Average
                    pred = (left + up[i]) >> 1
                else:  # Paeth
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                row[i] = (row[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"{path}: unknown row filter {ftype}")
        out[y] = prior = row
    return out


def read_png(path: str | Path) -> np.ndarray:
    """An 8-bit non-interlaced PNG -> (H, W, C) uint8: C = 1 grey, 2 grey +
    alpha, 3 RGB (a palette expanded), 4 RGBA."""
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise _unsupported(path, "not a PNG file")
    pos, header, palette, idat = len(SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            raise _unsupported(path, "transparency by tRNS is not read here")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise _unsupported(path, f"bit depth {depth}, colour type {ctype}")
    if interlace:
        raise _unsupported(path, "an interlaced PNG")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without PLTE")
    c = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), H, W * c, c, path).reshape(H, W, c)
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: a palette index beyond PLTE")
        px = palette[px[..., 0]]
    return px


def to_rgba(px: np.ndarray) -> np.ndarray:
    """``read_png``'s pixels -> (H, W, 4) uint8, as Pillow's
    ``convert("RGBA")``: grey spread over RGB, alpha 255 where none."""
    c = px.shape[2]
    rgb = px[..., :1].repeat(3, axis=2) if c in (1, 2) else px[..., :3]
    alpha = px[..., -1:] if c in (2, 4) else np.full(px.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=2)


def to_grey(px: np.ndarray) -> np.ndarray:
    """``read_png``'s pixels -> (H, W, 1) uint8, as Pillow's
    ``convert("L")``: alpha dropped, RGB by ITU-R 601-2 luma in fixed
    point."""
    if px.shape[2] in (1, 2):
        return px[..., :1].copy()
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)[..., None]


def to_tensor(px: np.ndarray, value_range: tuple[float, float] = (-1.0, 1.0)) -> np.ndarray:
    """``read_png``'s (or ``to_grey``'s) pixels -> (1, H, W, 3) float32 in
    ``value_range``: ``to_rgba``, then ``pil_to_tensor``'s own arithmetic
    (``utils/image.py:rgba_to_range``)."""
    return rgba_to_range(to_rgba(px), value_range)[None].astype(np.float32)
