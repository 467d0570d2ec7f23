"""Gaussians to a binary PLY for the Inria / Polycam viewers (counterpart
of latentsplat_tpu/model/ply_export.py), on the host with numpy.

The scene is shifted so that the median Gaussian is at the origin, scaled
so that most Gaussians lie in [-1, 1], and rotated into a +Z-up frame with
the viewer's default 45-degree yaw and the reference camera's rotation
undone. Each vertex holds its position, zero normals, the DC band of its
color harmonics, its opacity, log scales and a wxyz quaternion. The
binary little-endian container is written and read directly, and the one
rotation into the viewer's frame uses the quaternion helpers below.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import torch


def construct_list_of_attributes(num_rest: int) -> List[str]:
    attributes = ["x", "y", "z", "nx", "ny", "nz"]
    attributes += [f"f_dc_{i}" for i in range(3)]
    attributes += [f"f_rest_{i}" for i in range(num_rest)]
    attributes.append("opacity")
    attributes += [f"scale_{i}" for i in range(3)]
    attributes += [f"rot_{i}" for i in range(4)]
    return attributes


def _write_binary_ply(path: Path, names: List[str], data: np.ndarray) -> None:
    """data: (n, len(names)) float32 -> binary_little_endian PLY."""
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {data.shape[0]}"]
    header += [f"property float {name}" for name in names] + ["end_header"]
    path.parent.mkdir(exist_ok=True, parents=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, dtype="<f4").tobytes())


def load_ply(path: Path) -> dict:
    """Read back a PLY written by `export_ply` -> {name: (n,) float32}."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        names = [line.split()[-1] for line in header if line.startswith("property float")]
        n = int(next(line for line in header if line.startswith("element vertex")).split()[-1])
        data = np.frombuffer(f.read(n * len(names) * 4), dtype="<f4")
    data = data.reshape(n, len(names))
    return {name: data[:, i] for i, name in enumerate(names)}


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """(n, 4) xyzw quaternions (normalized here) -> (n, 3, 3), float64."""
    x, y, z, w = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float64).T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


def matrix_to_quaternion(m: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations -> (n, 4) unit xyzw quaternions (Shepperd's
    method: the formula of the largest component)."""
    m = np.asarray(m, np.float64)
    d = np.stack([m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], axis=-1)
    squares = np.stack([1 + d.sum(-1), 1 + d[:, 0] - d[:, 1] - d[:, 2],
                        1 - d[:, 0] + d[:, 1] - d[:, 2], 1 - d[:, 0] - d[:, 1] + d[:, 2]], axis=-1)
    a21, a12, a02, a20, a10, a01 = (m[:, 2, 1], m[:, 1, 2], m[:, 0, 2], m[:, 2, 0], m[:, 1, 0], m[:, 0, 1])
    candidates = np.stack([
        np.stack([a21 - a12, a02 - a20, a10 - a01, squares[:, 0]], axis=-1),
        np.stack([squares[:, 1], a01 + a10, a02 + a20, a21 - a12], axis=-1),
        np.stack([a01 + a10, squares[:, 2], a12 + a21, a02 - a20], axis=-1),
        np.stack([a02 + a20, a12 + a21, squares[:, 3], a10 - a01], axis=-1),
    ], axis=1)
    chosen = candidates[np.arange(m.shape[0]), squares.argmax(-1)]
    return chosen / np.linalg.norm(chosen, axis=-1, keepdims=True)


def _z_rotation(degrees: float) -> np.ndarray:
    """Rotation about +z, through its quaternion as the JAX package's
    scipy call builds it, float32."""
    half = np.deg2rad(degrees) / 2
    return quaternion_to_matrix(np.array([[0.0, 0.0, np.sin(half), np.cos(half)]]))[0].astype(np.float32)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def export_ply(
    extrinsics,   # (4, 4) camera-to-world of a reference camera
    means,        # (g, 3)
    scales,       # (g, 3)
    rotations,    # (g, 4) xyzw quaternions
    harmonics,    # (g, 3, d_sh) color harmonics
    opacities,    # (g,)
    path: Path,
) -> None:
    """Tensors (any device) or arrays -> one PLY vertex per Gaussian."""
    means, scales, rotations, harmonics, opacities, extrinsics = map(
        _host, (means, scales, rotations, harmonics, opacities, extrinsics)
    )
    means = means - np.median(means, axis=0)
    scale_factor = max(np.quantile(np.abs(means), 0.95, axis=0).max(), 1e-12)
    means = means / scale_factor
    scales = scales / scale_factor

    rotation = np.asarray([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rotation = _z_rotation(-45.0) @ rotation
    rotation = rotation @ np.linalg.inv(extrinsics[:3, :3])
    means = means @ rotation.T

    rot_mats = rotation[None].astype(np.float64) @ quaternion_to_matrix(rotations)
    x, y, z, w = matrix_to_quaternion(rot_mats).T
    quats_wxyz = np.stack([w, x, y, z], axis=-1).astype(np.float32)

    data = np.concatenate(
        [means, np.zeros_like(means), harmonics[..., 0], opacities[:, None],
         np.log(np.maximum(scales, 1e-12)), quats_wxyz],
        axis=1,
    ).astype(np.float32)
    _write_binary_ply(Path(path), construct_list_of_attributes(0), data)
