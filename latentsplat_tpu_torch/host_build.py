"""Build and load the port's host C library (the JPEG decoder and the
LANCZOS and BILINEAR resampler of the data pipeline and the figures).

Every `csrc_host/*.c` file is compiled with the host C compiler (`$CC`,
else `cc`) into one shared library in `build/host/` at the repository
root, named by a hash of the sources and flags, and loaded with ctypes.
Nothing is built at import: the first decode or resize builds. The build
runs under a file lock, so the loader's worker processes, which start
together, build it once between them. The flags keep the floating-point
arithmetic (the resampler's filter taps) the same on every machine: no
fused multiply-add, no fast-math.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

CSRC_DIR = Path(__file__).resolve().parent / "csrc_host"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host"
CFLAGS = ["-O2", "-fPIC", "-ffp-contract=off", "-std=c99", "-D_DEFAULT_SOURCE", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_S = ctypes.c_char_p
# C signature of each exported function: (argument types, result type).
_SIGNATURES = {
    "jpeg_header": ([_P, _L, _P, _P, _P, _S, _I], _I),
    "jpeg_decode": ([_P, _L, _P, _I, _I, _S, _I], _I),
    "resample": ([_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I], _I),
}

# The loaded library of this process: never an attribute of a dataset,
# which is pickled into the loader's worker processes.
_library = None


def _compiler() -> str:
    name = os.environ.get("CC", "cc")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"no C compiler {name!r} found: the data pipeline's JPEG decoder and resampler need one")
    return found


def library_path() -> Path:
    sources = sorted(CSRC_DIR.glob("*.c"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libhost_{digest.hexdigest()[:16]}.so"


def build(lib_path: Path) -> None:
    """Compile every csrc_host/*.c into `lib_path`, unless another process
    did so while this one waited for the lock."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib_path.exists():
                return
            tmp_path = lib_path.parent / f"{lib_path.stem}.{os.getpid()}.tmp.so"
            sources = [str(s) for s in sorted(CSRC_DIR.glob("*.c"))]
            result = subprocess.run([_compiler(), *CFLAGS, "-o", str(tmp_path), *sources, "-lm"],
                                    capture_output=True, text=True)
            if result.returncode != 0:
                tmp_path.unlink(missing_ok=True)
                raise RuntimeError(f"building {lib_path.name} failed ({result.returncode}):\n{result.stderr[-4000:]}")
            os.replace(tmp_path, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the host library."""
    global _library
    if _library is not None:
        return _library
    lib_path = library_path()
    if not lib_path.exists():
        build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _library = lib
    return lib


# Pillow's numbers for the resampling filters that csrc_host/resample.c has.
FILTERS = {"lanczos": 1, "bilinear": 2}


def resample(image: np.ndarray, shape: tuple[int, int], filter: str,
             window: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """uint8 (h, w, c) -> uint8 resize to `shape` (h, w) with Pillow's
    LANCZOS or BILINEAR arithmetic; with `window` (row, col, h, w), only that
    part of the resized image."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"resample takes uint8 (h, w, c) images, not {image.dtype} {image.shape}")
    h, w = shape
    row, col, win_h, win_w = window if window is not None else (0, 0, h, w)
    image = np.ascontiguousarray(image)
    out = np.empty((win_h, win_w, image.shape[2]), np.uint8)
    rc = load_library().resample(
        image.ctypes.data, image.shape[0], image.shape[1], image.shape[2], out.ctypes.data, h, w,
        row, col, win_h, win_w, FILTERS[filter],
    )
    if rc != 0:
        raise ValueError(f"resample ({filter}): {image.shape} -> {shape}, window {window}")
    return out
