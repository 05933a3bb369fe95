"""Image files without PIL: 8-bit PNG through ``zlib`` and ``struct``.

The JAX package reads and writes every image through PIL.  The port reads a
PNG itself, so that the recipe runs where PIL is not installed, and returns
the arrays PIL would return for the same file: a file is decoded by its
signature, never by its extension, as ``Image.open`` does.  Supported: bit
depth 8, colour types grey, grey + alpha, palette, RGB and RGBA, not
interlaced, all five row filters.  A 16-bit, sub-byte or interlaced PNG
raises ``NotImplementedError``; no call returns an array PIL would not.
Anything that is not a PNG (a VOC JPEG) goes through PIL, imported at the
call; without PIL that raises an ``ImportError`` naming the file and its
format.

Conversions follow PIL's: ``convert("RGB")`` looks palette indices up,
repeats grey and drops alpha without compositing; ``convert("L")`` of colour
pixels is ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``.

:func:`write_png` writes filter 0 (None) on every row, so the files the
recipe writes itself decode at numpy speed; the Average and Paeth filters
(which only other writers, PIL among them, choose) take a loop over columns.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, PIL mode)
_COLOUR_TYPES = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"), 6: (4, "RGBA")}
_SIGNATURES = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
               (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"))


def _sniff(head: bytes) -> str:
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    for sig, name in _SIGNATURES:
        if head.startswith(sig):
            return name
    return "unknown"


def _head(path: str, n: int = 33) -> bytes:
    with open(path, "rb") as f:
        return f.read(n)


def _pil_open(path: str, fmt: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path} is a {fmt} file, which needs PIL (not installed); only PNG "
                          "files are read without it") from e
    return Image.open(path)


def _ihdr(head: bytes, path: str) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) from a PNG's first bytes."""
    length, kind = struct.unpack(">I4s", head[8:16])
    if kind != b"IHDR" or length != 13:
        raise ValueError(f"{path}: PNG without an IHDR chunk first")
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", head[16:29])
    return w, h, depth, ctype, interlace


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) from the file's header only."""
    head = _head(path)
    fmt = _sniff(head)
    if fmt == "PNG":
        w, h = _ihdr(head, path)[:2]
        return h, w
    with _pil_open(path, fmt) as im:
        w, h = im.size
    return h, w


def image_mode(path: str) -> str:
    """The file's PIL mode (``Image.open(path).mode``: "RGB", "L", "P", ...)
    from its header only.  A PNG that :func:`read_raw` does not read raises
    ``NotImplementedError``, as the readers do."""
    head = _head(path)
    fmt = _sniff(head)
    if fmt != "PNG":
        with _pil_open(path, fmt) as im:
            return im.mode
    _w, _h, depth, ctype, interlace = _ihdr(head, path)
    if ctype not in _COLOUR_TYPES:
        raise ValueError(f"{path}: invalid PNG colour type {ctype}")
    if depth != 8 or interlace:
        raise NotImplementedError(f"{path}: only 8-bit, non-interlaced PNGs are read without PIL")
    return _COLOUR_TYPES[ctype][1]


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters of 8-bit samples -> (h, w * bpp) uint8."""
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"{path}: {data.size} bytes of image data, expected {h * (stride + 1)}")
    rows = data.reshape(h, stride + 1)
    kinds, rows = rows[:, 0], rows[:, 1:]
    if not kinds.any():  # every row unfiltered: what write_png gives
        return rows.copy()
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(kinds[y]), rows[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(row.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            out[y] = row + prior
        elif kind in (3, 4):  # Average / Paeth: depend on the reconstructed left pixel
            cur = row.reshape(w, bpp).astype(np.int16)
            up = prior.reshape(w, bpp).astype(np.int16)
            left = np.zeros(bpp, np.int16)
            upleft = np.zeros(bpp, np.int16)
            for x in range(w):
                pred = (left + up[x]) // 2 if kind == 3 else _paeth(left, up[x], upleft)
                left = (cur[x] + pred) & 0xFF
                cur[x] = left
                upleft = up[x]
            out[y] = cur.reshape(stride).astype(np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {kind} in row {y}")
        prior = out[y]
    return out


def _read_png(path: str):
    """(samples (h, w) or (h, w, c) uint8, PIL mode, palette (n, 3) uint8 or None)."""
    with open(path, "rb") as f:
        blob = f.read()
    w, h, depth, ctype, interlace = _ihdr(blob, path)
    if ctype not in _COLOUR_TYPES:
        raise ValueError(f"{path}: invalid PNG colour type {ctype}")
    if depth != 8:
        raise NotImplementedError(f"{path}: {depth}-bit PNG; only 8-bit samples are read without PIL")
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG; only non-interlaced files are read without PIL")
    channels, mode = _COLOUR_TYPES[ctype]
    pos, idat, palette = 8, [], None
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos: pos + 8])
        body = blob[pos + 8: pos + 8 + length]
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    samples = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels, path)
    shape = (h, w) if channels == 1 else (h, w, channels)
    return samples.reshape(shape), mode, palette


def _full_palette(palette: np.ndarray) -> np.ndarray:
    """PIL's 256-entry palette: entries the file does not list are black."""
    out = np.zeros((256, 3), np.uint8)
    out[: min(len(palette), 256)] = palette[:256]
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of RGB pixels (ITU-R 601-2, fixed point)."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_raw(path: str) -> np.ndarray:
    """The file's samples as ``np.asarray(Image.open(path))`` gives them:
    palette indices, grey levels, or (h, w, c) colour and alpha channels."""
    fmt = _sniff(_head(path))
    if fmt != "PNG":
        with _pil_open(path, fmt) as im:
            return np.asarray(im)
    return _read_png(path)[0]


def read_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``np.asarray(Image.open(path).convert("RGB"))``."""
    fmt = _sniff(_head(path))
    if fmt != "PNG":
        with _pil_open(path, fmt) as im:
            return np.asarray(im.convert("RGB"))
    samples, mode, palette = _read_png(path)
    if mode == "P":
        return _full_palette(palette)[samples]
    if mode == "L":
        return np.repeat(samples[..., None], 3, axis=-1)
    if mode == "LA":
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def read_mask(path: str) -> np.ndarray:
    """(H, W) uint8 labels: palette indices or grey levels as stored, any
    other mode through ``convert("L")`` (``utils/palette.read_mask_png``)."""
    fmt = _sniff(_head(path))
    if fmt != "PNG":
        with _pil_open(path, fmt) as im:
            if im.mode in ("P", "L"):
                return np.asarray(im, dtype=np.uint8)
            return np.asarray(im.convert("L"), dtype=np.uint8)
    samples, mode, _ = _read_png(path)
    if mode in ("P", "L"):
        return samples
    if mode == "LA":
        return np.ascontiguousarray(samples[..., 0])
    return _luma(samples)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(array: np.ndarray, path: str,
              palette: Optional[Sequence[Tuple[int, int, int]]] = None) -> None:
    """Write an (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 array as an
    8-bit PNG; ``palette`` (up to 256 RGB triples) makes an (H, W) array a
    palette image of those indices.  Every row is unfiltered."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 arrays, got {a.dtype}")
    if a.ndim == 2:
        ctype = 0 if palette is None else 3
    elif a.ndim == 3 and a.shape[2] in (3, 4) and palette is None:
        ctype = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3|4) arrays, got {a.shape}"
                         + (" with a palette" if palette is not None else ""))
    h, w = a.shape[:2]
    rows = np.empty((h, 1 + a[0].size), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = a.reshape(h, -1)
    parts = [PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if not 1 <= len(pal) <= 256:
            raise ValueError(f"a PNG palette holds 1 to 256 colours, got {len(pal)}")
        parts.append(_chunk(b"PLTE", pal.tobytes()))
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))
