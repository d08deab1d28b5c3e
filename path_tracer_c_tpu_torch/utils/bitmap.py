"""BMP output, byte for byte the JAX package's ``utils/bitmap.py``.

24-bit uncompressed BMP: 14-byte file header and 40-byte BITMAPINFOHEADER,
little-endian fields, rows padded to 4 bytes, pixels in BGR order, bottom-
up rows when ``y_inverted`` (row 0 of the input is the image top). The
numpy encoder only; the JAX package's native encoder is not carried over.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["bitmap_bytes", "write_bitmap"]


def bitmap_bytes(pixels: np.ndarray, y_inverted: bool = True) -> bytes:
    """Serialize an (H, W, 3) uint8 RGB image to BMP bytes.

    ``y_inverted=True`` means row 0 of ``pixels`` is the image *top* and
    must be flipped into BMP's bottom-up order — matching the semantics of
    ``write_bitmap(..., y_inverted)`` at src/bitmap.c:45-59 where the flag
    says "pixels[0] is the top row".
    """
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {pixels.shape}")
    h, w, _ = pixels.shape
    row_padding = (4 - (w * 3) % 4) % 4  # src/bitmap.c:8
    stride = 3 * w + row_padding
    file_size = 14 + 40 + stride * h

    header = b"BM" + struct.pack("<III", file_size, 0, 54)  # src/bitmap.c:11-18
    info = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h, 0, 0, 0, 0
    )  # src/bitmap.c:20-42

    bgr = pixels[:, :, ::-1]  # BGR order, src/bitmap.c:51-53
    if y_inverted:
        bgr = bgr[::-1]  # top-down input -> bottom-up BMP rows
    if row_padding:
        padded = np.zeros((h, stride), dtype=np.uint8)
        padded[:, : 3 * w] = bgr.reshape(h, 3 * w)
        data = padded.tobytes()
    else:
        data = bgr.tobytes()
    return header + info + data


def write_bitmap(filename, pixels, y_inverted: bool = True) -> None:
    """Write an (H, W, 3) uint8 RGB image as a 24-bit BMP."""
    with open(filename, "wb") as f:
        f.write(bitmap_bytes(pixels, y_inverted=y_inverted))
