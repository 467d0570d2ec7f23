"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc for sm_90a into one shared
library with a plain C interface, loaded with ctypes. The library lands in
`build/kernels/` at the repository root, named by a hash of the sources, so
a changed source triggers a rebuild and an unchanged one is reused.
Nothing is built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each exported function: (argument types, result type).
_SIGNATURES = {
    "duplicate_with_keys": ([_I, _P, _P, _P, _P, _P, _I, _P, _P, _P], _I),
    "composite_forward": ([_I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P], _I),
    "composite_forward_channels": ([_I], _I),
    "composite_backward": ([_I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "reduce_pairs": ([_I, _I, _P, _P, _P, _P, _P], _I),
}

_library = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _library
    if _library is not None:
        return _library
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    start = time.perf_counter()
    built = False
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp_path = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp_path, lib_path)
        built = True
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    build_info.update(
        path=str(lib_path), built=built, seconds=time.perf_counter() - start,
        sources=[str(s.relative_to(CSRC_DIR.parent.parent)) for s in sources],
        log=log_path.read_text() if log_path.exists() else "",
    )
    _library = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
