"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc for sm_90a, one nvcc process
per source, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes. The library
lands in `build/kernels/` at the repository root, named by a hash of the
sources, so a changed source triggers a rebuild and an unchanged one is
reused. Nothing is built at import: the first kernel launch builds.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each exported function: (argument types, result type).
_SIGNATURES = {
    "duplicate_with_keys": ([_I, _P, _P, _P, _P, _P, _I, _P, _P, _P], _I),
    "duplicate_with_keys64": ([_I, _P, _P, _P, _P, _P, _I, _P, _P, _P], _I),
    "composite_forward": ([_I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P], _I),
    "composite_forward_channels": ([_I], _I),
    "composite_backward": ([_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "reduce_pairs": ([_I, _I, _P, _P, _P, _P], _I),
}

_library = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def compile_library(sources: list[Path], lib_path: Path) -> None:
    """Compile `sources` (one nvcc each, in parallel) and link them into the
    shared library `lib_path`; the compiler's output goes beside it (.log)."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objects = [lib_path.parent / f"{tag}.{src.stem}.o" for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objects)
    ]
    tmp_path = lib_path.parent / f"{tag}.tmp.so"
    try:
        logs = [(src, proc, proc.communicate()[0]) for src, proc in zip(sources, procs)]
        lib_path.with_suffix(".log").write_text("".join(f"== {src.name}\n{out}" for src, _, out in logs))
        for src, proc, out in logs:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out[-4000:]}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_path), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp_path, lib_path)


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
    built = not lib_path.exists()
    if built:
        compile_library(sources, lib_path)
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
