"""Procedural multi-view dataset (counterpart of
latentsplat_tpu/dataset/synthetic.py: the same scenes, cameras, numpy
splatter, shuffles and augmentation from the same seeds).

Scenes of colored 3D Gaussian blobs rendered by a small numpy splatter,
with cameras on an arc, so that training, validation and test run without
mounted RE10k or CO3D data.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from .shims import shard_rows
from .types import DatasetSyntheticCfg, RowShard, Stage
from .view_samplers import ViewSampler


def _look_at(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    z = target - position
    z = z / np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0], np.float32)
    x = np.cross(up, z)
    x = x / (np.linalg.norm(x) + 1e-9)
    y = np.cross(z, x)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 0], ext[:3, 1], ext[:3, 2], ext[:3, 3] = x, y, z, position
    return ext


def render_blob_scene(
    means: np.ndarray,       # (k, 3)
    colors: np.ndarray,      # (k, 3)
    radii: np.ndarray,       # (k,)
    extrinsics: np.ndarray,  # (4, 4) camera to world
    intrinsics: np.ndarray,  # (3, 3) normalized
    shape: tuple[int, int],
) -> np.ndarray:
    """Front-to-back alpha compositing of isotropic blobs, O(k * pixels)."""
    h, w = shape
    w2c = np.linalg.inv(extrinsics)
    p = means @ w2c[:3, :3].T + w2c[:3, 3]
    z = p[:, 2]
    order = np.argsort(z)
    p, z, colors, radii = p[order], z[order], colors[order], radii[order]

    ys, xs = np.mgrid[0:h, 0:w]
    u = (xs + 0.5) / w
    v = (ys + 0.5) / h

    img = np.zeros((h, w, 3), np.float32)
    transmittance = np.ones((h, w), np.float32)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    for i in range(means.shape[0]):
        if z[i] <= 0.05:
            continue
        pu = fx * p[i, 0] / z[i] + cx
        pv = fy * p[i, 1] / z[i] + cy
        sigma = radii[i] / z[i]
        d2 = (u - pu) ** 2 + (v - pv) ** 2
        alpha = 0.9 * np.exp(-0.5 * d2 / (sigma**2))
        img += (transmittance * alpha)[..., None] * colors[i]
        transmittance *= 1.0 - alpha
    # Gray background for contrast.
    img += transmittance[..., None] * 0.2
    return np.clip(img, 0.0, 1.0)


class DatasetSynthetic:
    near = 0.5
    far = 20.0

    def __init__(
        self,
        cfg: DatasetSyntheticCfg,
        stage: Stage,
        view_sampler: ViewSampler,
        force_shuffle: bool = False,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.rng = np.random.default_rng(cfg.seed + seed)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.row_shard = RowShard()

    def _scene(self, scene_id: int):
        rng = np.random.default_rng(self.cfg.seed * 7919 + scene_id)
        k = 48
        means = rng.uniform(-1.5, 1.5, size=(k, 3)).astype(np.float32)
        means[:, 2] = rng.uniform(2.0, 6.0, size=k)
        colors = rng.uniform(0.1, 1.0, size=(k, 3)).astype(np.float32)
        radii = rng.uniform(0.05, 0.3, size=k).astype(np.float32)

        n = self.cfg.num_frames
        angles = np.linspace(-0.35, 0.35, n)
        extrinsics = np.stack([
            _look_at(
                np.array([2.5 * np.sin(a), 0.3 * np.sin(2 * a), -2.5 * np.cos(a) + 2.0], np.float32),
                np.array([0.0, 0.0, 4.0], np.float32),
            )
            for a in angles
        ])
        intrinsics = np.tile(
            np.asarray([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]], np.float32), (n, 1, 1)
        )
        return means, colors, radii, extrinsics, intrinsics

    def __iter__(self):
        scene_ids = list(range(self.cfg.num_scenes))
        if self.num_shards > 1:
            scene_ids = scene_ids[self.shard_index :: self.num_shards]
        if self.stage in ("train", "val"):
            self.rng.shuffle(scene_ids)

        def candidates():
            for scene_id in scene_ids:
                means, colors, radii, extrinsics, intrinsics = self._scene(scene_id)
                n = extrinsics.shape[0]
                scene = f"synthetic_{scene_id:04d}"
                try:
                    view_indices = self.view_sampler.sample(scene, n, self.rng)
                except ValueError:
                    continue
                for view_index in view_indices:
                    yield partial(
                        self._make_sample, scene, means, colors, radii, extrinsics, intrinsics,
                        np.asarray(view_index.context), np.asarray(view_index.target), tuple(self.cfg.image_shape),
                    )

        yield from shard_rows(candidates(), self.row_shard, self.rng, self.stage == "train")

    def _make_sample(self, scene, means, colors, radii, extrinsics, intrinsics, ctx_idx, tgt_idx, shape):
        def views(indices):
            images = np.stack([
                render_blob_scene(means, colors, radii, extrinsics[i], intrinsics[i], shape) for i in indices
            ])
            n = len(indices)
            return {
                "extrinsics": extrinsics[indices],
                "intrinsics": intrinsics[indices],
                "image": images,
                "near": np.full((n,), self.near, np.float32),
                "far": np.full((n,), self.far, np.float32),
                "index": indices.astype(np.int32),
            }

        return {"context": views(ctx_idx), "target": views(tgt_idx), "scene": scene}

    def __len__(self) -> int:
        return self.cfg.num_scenes
