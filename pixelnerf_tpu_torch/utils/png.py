"""PNG reading and writing with no image library: ``zlib``, ``struct`` and
numpy.

``read_png`` decodes 8-bit, non-interlaced files of every colour type (gray,
gray + alpha, RGB, RGBA, palette), split IDAT chunks and all five row
filters, and returns what ``imageio.v2.imread`` returns for the same file:
gray as (H, W), gray + alpha as (H, W, 2), a palette expanded to RGB (a
``tRNS`` chunk is ignored, as there).  Anything else -- 16-bit or sub-byte
samples, interlacing, a chunk whose CRC does not match -- raises a
``ValueError`` that names the file.

The writer writes gray, RGB and RGBA in one IDAT chunk, with row filter 0
(none) on every row."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (bit depth 8)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}  # channels written -> colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 left, up and up-left bytes: with p = a +
    b - c, the nearest of a, b, c to p (ties in that order)."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)  # |p - a|, |p - b|, |p - c|
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) uint8 RGB image, or of an (H, W, 1) gray
    or (H, W, 4) RGBA one."""
    img = np.asarray(img)
    if (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE
            or 0 in img.shape[:2]):
        raise ValueError(
            "write_png writes (H, W, 3) uint8 RGB, (H, W, 4) uint8 RGBA or (H, W, 1) uint8 "
            f"gray images, got {img.dtype} {img.shape}")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOUR_TYPE[C], 0, 0, 0)  # 8-bit, no interlace
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3), (H, W, 4) or (H, W, 1) uint8 image to ``path`` as
    PNG; raises on any other array."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _chunks(data: bytes, path: str):
    """(tag, payload) of each chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: CRC mismatch in the {tag!r} chunk")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the row filters of 8-bit samples: ``raw`` is (H, 1 + W * bpp)
    with each row's filter byte first; returns (H, W, bpp) uint8.

    Without Average (3) or Paeth (4) rows, each row is one vector step (Sub
    is a running sum mod 256 along the row).  With them, pixel (y, x) needs
    its decoded left, upper and upper-left neighbours, so the image is
    decoded along anti-diagonals x + y = t: H + W - 1 vector steps, each over
    every row at once, in a skewed copy S[y, t] = pixel (y, t - y) where a
    diagonal is one column."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"row filter type {int(ftype.max())} is not a PNG filter")
    filt = raw[:, 1:].reshape(H, W, bpp)
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty((H, W, bpp), np.uint8)
        prev = np.zeros((W, bpp), np.uint8)
        for y in range(H):
            row, f = filt[y], ftype[y]
            if f == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif f == 2:
                row = row + prev
            out[y] = prev = row
        return out
    # S[y + 1, t + 2] = pixel (y, t - y); row 0 and columns 0-1 stay zero,
    # so a neighbour left of x = 0 or above y = 0 reads 0
    T = H + W - 1
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    S = np.zeros((H + 1, T + 2, bpp), np.int16)
    F = np.zeros((H, T, bpp), np.int16)
    F[ys, ys + xs] = filt
    ft = ftype.astype(np.int16)[:, None]
    not_paeth = np.concatenate([[0], np.cumsum(ftype != 4)])  # rows [0, y) not Paeth
    for t in range(T):
        y0, y1 = max(0, t - W + 1), min(H, t + 1)  # rows on this diagonal
        a = S[y0 + 1:y1 + 1, t + 1]  # left: (y, x - 1)
        b = S[y0:y1, t + 1]  # up: (y - 1, x)
        c = S[y0:y1, t]  # up-left: (y - 1, x - 1)
        pred = _paeth(a, b, c)
        if not_paeth[y1] != not_paeth[y0]:  # a diagonal of other filters too
            f = ft[y0:y1]
            pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
                f == 3, (a + b) >> 1, np.where(f == 4, pred, 0))))
        out = S[y0 + 1:y1 + 1, t + 2]
        np.add(F[y0:y1, t], pred, out=out)
        out &= 255
    return S[ys + 1, ys + xs + 2].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at ``path`` -> uint8 (H, W) gray or (H, W, C),
    C = 2 (gray + alpha), 3 (RGB, or a palette expanded) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    header = palette = None
    idat = []
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit PNG samples are read "
                         f"(bit depth {depth}, colour type {ctype})")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not read")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if len(raw) != H * (1 + W * bpp):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"expected {H * (1 + W * bpp)}")
    try:
        img = _unfilter(np.frombuffer(raw, np.uint8).reshape(H, 1 + W * bpp), H, W, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if ctype == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the PLTE chunk")
        return palette[img[..., 0]]
    return img[..., 0] if bpp == 1 else img
