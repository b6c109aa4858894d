"""Minimal PNG writer/reader for 8-bit RGB images (zlib, no PIL).

Writes one IDAT chunk with filter type 0 on every row; reads back what
`write_png` writes (8-bit RGB, non-interlaced, filter 0), which is all
the repository needs to round-trip its own files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(u8: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3] uint8 -> PNG file bytes."""
    u8 = np.ascontiguousarray(u8)
    if u8.dtype != np.uint8 or u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {u8.dtype} {u8.shape}")
    h, w, _ = u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(u8: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(u8))


def read_png(path: str) -> np.ndarray:
    """PNG written by `write_png` -> [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are supported")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * 3)
    if np.any(rows[:, 0] != 0):
        raise ValueError(f"{path}: only filter type 0 is supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
