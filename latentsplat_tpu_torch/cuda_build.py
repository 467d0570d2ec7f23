"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc for sm_90a, one nvcc process
per source, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes. The library
lands in `build/kernels/` at the repository root, named by a hash of the
sources, so a changed source triggers a rebuild and an unchanged one is
reused. Nothing is built at import: the first kernel launch builds. The
composite kernels' fast-family variants are instantiated only at the
channel counts the splatting decoder reaches (`composite_fast_channels`:
5, 8 and 12), beside the exact ones at 4, 5, 8 and 12.

Every kernel is launched through `launch`, which calls a C entry point,
raises on the CUDA error it reports and counts the launch in `launches`,
keyed by (kernel, variant, channels): the kernel's name (one of KERNELS),
a composite kernel's variant, "shift" for a group norm launched with a
per-channel shift of its input ("exact" for every other launch) and the
channel count a compositing kernel was launched for (0 for the others).
`launched` sums it over any of the three.
"""

from __future__ import annotations

import collections
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
_F = ctypes.c_float
# C signature of each exported function: (argument types, result type).
_SIGNATURES = {
    "duplicate_with_keys": ([_I, _P, _P, _P, _P, _P, _I, _P, _P, _P], _I),
    "duplicate_with_keys64": ([_I, _P, _P, _P, _P, _P, _I, _P, _P, _P], _I),
    "composite_forward": ([_I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P], _I),
    "composite_forward_channels": ([_I], _I),
    "composite_fast_channels": ([_I], _I),
    "composite_forward_fast": ([_I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "composite_backward": ([_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "composite_backward_fast": (
        [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P], _I),
    "reduce_pairs": ([_I, _I, _P, _P, _P, _P], _I),
    "tile_cull": ([_I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
    "shade_project": ([_I] * 12 + [_P] * 16, _I),
    "group_norm_silu_forward": ([_I, _I, _I, _I, _I, _F, _I, _I] + [_P] * 9, _I),
    "group_norm_silu_backward": ([_I] * 7 + [_P] * 12, _I),
    "residual_add": ([_I, _I, _I] + [_P] * 6, _I),
}

# The kernels that `launch` counts, under these names: a C entry point's
# variants (duplicate_with_keys64, composite_forward_fast, ...) count under
# their kernel's.
KERNELS = ("duplicate_with_keys", "composite_forward", "composite_backward", "reduce_pairs", "tile_cull",
           "shade_project", "group_norm_silu", "group_norm_silu_backward", "residual_add")

_library = None
build_info: dict = {}
launches: collections.Counter = collections.Counter()


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


def launch(entry: str, *args, kernel: str, variant: str = "exact", channels: int = 0) -> None:
    """Call the C entry point `entry` with `args` (loading the library on
    first use) and count one launch of `kernel`; raises, naming the kernel
    and counting nothing, where the entry point reports a CUDA error."""
    rc = getattr(load_library(), entry)(*args)
    if rc != 0:
        name = kernel if variant == "exact" else f"{kernel} ({variant})"
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    launches[kernel, variant, channels] += 1


def launched(kernel: str, variant: str | None = None, channels: int | None = None,
             counts: collections.Counter | None = None) -> int:
    """Launches of `kernel` so far (in `counts`, a copy of `launches`, where
    given), of `variant` and at `channels` where given, of any where not."""
    return sum(n for (k, v, c), n in (launches if counts is None else counts).items()
               if k == kernel and variant in (None, v) and channels in (None, c))
