"""Image and video IO on the host (counterpart of
latentsplat_tpu/misc/image_io.py), without PIL.

PNG files are written and read with zlib and struct from the standard
library: 8-bit RGB, no interlace, every row with filter type 0, the pixels
in one IDAT chunk. `load_image` reads files of that form (several IDAT
chunks included) and refuses others. Images are NHWC floats in [0, 1].
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path
from typing import Iterable, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def prep_image(image: np.ndarray) -> np.ndarray:
    """float [0, 1] (h, w[, c]) -> uint8 (h, w, 3)."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    return (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 (h, w, 3) -> the bytes of a PNG file."""
    h, w, c = pixels.shape
    assert pixels.dtype == np.uint8 and c == 3, (pixels.dtype, pixels.shape)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG file of the form `encode_png` writes -> uint8 (h, w, 3)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"only 8-bit RGB PNGs without interlace are read (depth {depth}, color type {color})")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only PNG rows with filter type 0 are read")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_image(image: np.ndarray, path: Union[Path, str]) -> None:
    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    path.write_bytes(encode_png(prep_image(image)))


def load_image(path: Union[Path, str]) -> np.ndarray:
    """PNG -> float32 (h, w, 3) in [0, 1]."""
    return decode_png(Path(path).read_bytes()).astype(np.float32) / 255.0


def save_video(frames: Iterable[np.ndarray], path: Union[Path, str], fps: int = 30) -> bool:
    """Write frames (NHWC [0, 1]) to an mp4 with ffmpeg; returns False when
    ffmpeg is missing, and the frames are then PNGs in a folder beside `path`."""
    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    frames = list(frames)
    if shutil.which("ffmpeg") is None:
        stem_dir = path.with_suffix("")
        stem_dir.mkdir(exist_ok=True, parents=True)
        for i, f in enumerate(frames):
            save_image(f, stem_dir / f"{i:0>6}.png")
        return False
    with tempfile.TemporaryDirectory() as tmp:
        for i, f in enumerate(frames):
            save_image(f, Path(tmp) / f"{i:0>6}.png")
        cmd = [
            "ffmpeg", "-y", "-framerate", str(fps),
            "-pattern_type", "glob", "-i", os.path.join(tmp, "*.png"),
            "-c:v", "libx264", "-pix_fmt", "yuv420p",
            "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
            str(path),
        ]
        subprocess.run(cmd, check=True, capture_output=True)
    return True
