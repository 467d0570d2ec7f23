"""JPEG decoding on the host without PIL, through the port's C decoder
(`csrc_host/jpeg_decode.c`): baseline and extended sequential Huffman
files, 8-bit, grayscale or YCbCr with 1 or 2 sampling per axis, with the
same output bits as libjpeg-turbo's default decode (and so PIL's).
Any other mode raises ValueError naming the marker; a damaged file
(truncated, corrupt tables or data, not a JPEG) raises CorruptJPEGError,
a ValueError too.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import host_build

_ERR_SIZE = 256
_DAMAGED = -1   # the C functions' return codes; -2: a mode not taken


class CorruptJPEGError(ValueError):
    """The file is damaged, where PIL raises OSError."""


def _check(rc: int, err: ctypes.Array) -> None:
    if rc != 0:
        message = f"JPEG: {err.value.decode(errors='replace')}"
        raise CorruptJPEGError(message) if rc == _DAMAGED else ValueError(message)


def jpeg_size(data: bytes) -> tuple[int, int, int]:
    """(height, width, components) from the frame header."""
    lib = host_build.load_library()
    buf = np.frombuffer(data, np.uint8)
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_SIZE)
    _check(lib.jpeg_header(buf.ctypes.data, buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(n),
                           err, _ERR_SIZE), err)
    return h.value, w.value, n.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """The bytes of a JPEG file -> uint8 (h, w, 3) RGB; grayscale is
    replicated to the three channels, as PIL's convert("RGB") does."""
    lib = host_build.load_library()
    buf = np.frombuffer(data, np.uint8)
    h, w, _ = jpeg_size(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_SIZE)
    _check(lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, w, h, err, _ERR_SIZE), err)
    return out
