"""RealEstate10k chunk dataset (counterpart of
latentsplat_tpu/dataset/re10k.py: the same chunks, filters, random draws
and examples).

Streams `.torch` chunk files: each a list of scenes, {"key": str,
"cameras": (n, 18) float tensor, "images": n uint8 tensors of JPEG bytes,
...}, read with `torch.load(weights_only=True)`. Converts the 18-float
poses into normalized intrinsics and OpenCV camera-to-world extrinsics,
skips wide-FOV scenes and frames that are not 360x640, normalizes the
context baseline to 1, and applies the augmentation and crop shims.
Frames are decoded by the port's C decoder (`dataset.jpeg`), not PIL.
"""

from __future__ import annotations

import json
from functools import cached_property, partial
from pathlib import Path

import numpy as np
import torch

from .jpeg import decode_jpeg
from .shims import apply_crop_shim, shard_rows
from .types import DatasetRE10kCfg, RowShard, Stage
from .view_samplers import ViewSampler, ViewSamplerEvaluation

NEAR = 0.1
FAR = 1000.0


def convert_poses(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(b, 18) -> (c2w extrinsics (b, 4, 4), normalized intrinsics (b, 3, 3))."""
    b = poses.shape[0]
    intrinsics = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    intrinsics[:, 0, 0] = poses[:, 0]
    intrinsics[:, 1, 1] = poses[:, 1]
    intrinsics[:, 0, 2] = poses[:, 2]
    intrinsics[:, 1, 2] = poses[:, 3]
    w2c = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    w2c[:, :3] = poses[:, 6:].reshape(b, 3, 4)
    return np.linalg.inv(w2c), intrinsics


def _fov_deg(intrinsics: np.ndarray) -> np.ndarray:
    fov_x = 2.0 * np.arctan(0.5 / intrinsics[:, 0, 0])
    fov_y = 2.0 * np.arctan(0.5 / intrinsics[:, 1, 1])
    return np.degrees(np.stack([fov_x, fov_y], -1))


class DatasetRE10k:
    """Iterable over (context, target) examples."""

    def __init__(
        self,
        cfg: DatasetRE10kCfg,
        stage: Stage,
        view_sampler: ViewSampler,
        force_shuffle: bool = False,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.force_shuffle = force_shuffle
        self.rng = np.random.default_rng(seed)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.row_shard = RowShard()

        self.chunks: list[Path] = []
        for root in cfg.roots:
            root = Path(root) / self.data_stage
            self.chunks.extend(sorted(p for p in root.iterdir() if p.suffix == ".torch"))
        if cfg.overfit_to_scene is not None:
            chunk_path = self.index[cfg.overfit_to_scene]
            self.chunks = [chunk_path] * len(self.chunks)

    @staticmethod
    def _load_chunk(path: Path) -> list:
        return torch.load(path, map_location="cpu", weights_only=True)

    def __iter__(self):
        chunks = list(self.chunks)
        if self.stage in ("train", "val") or self.force_shuffle:
            self.rng.shuffle(chunks)
        if self.stage == "test" and self.num_shards > 1:
            chunks = [c for i, c in enumerate(chunks) if i % self.num_shards == self.shard_index]

        def candidates():
            for chunk_path in chunks:
                chunk = self._load_chunk(chunk_path)
                if self.cfg.overfit_to_scene is not None:
                    item = [x for x in chunk if x["key"] == self.cfg.overfit_to_scene]
                    assert len(item) == 1
                    chunk = item * len(chunk)
                if self.stage in ("train", "val"):
                    self.rng.shuffle(chunk)
                for example in chunk:
                    yield from self._candidates(example)

        augment = self.stage == "train" and self.cfg.augment
        for sample in shard_rows(candidates(), self.row_shard, self.rng, augment):
            yield apply_crop_shim(sample, tuple(self.cfg.image_shape))

    def _candidates(self, example):
        """A loader (`_load_sample`) of each of the example's view draws that
        passes the checks made without its images: one row each."""
        extrinsics, intrinsics = convert_poses(np.asarray(example["cameras"], np.float32))
        scene = example["key"]
        if (_fov_deg(intrinsics) > self.cfg.max_fov).any():
            return
        try:
            view_indices = self.view_sampler.sample(scene, extrinsics.shape[0], self.rng)
        except ValueError:
            return

        for view_index in view_indices:
            ctx_idx = np.asarray(view_index.context)
            tgt_idx = np.asarray(view_index.target)
            ext = extrinsics.copy()
            scale = 1.0
            if len(ctx_idx) == 2 and self.cfg.make_baseline_1:
                a, b = ext[ctx_idx][:, :3, 3]
                scale = float(np.linalg.norm(a - b))
                if scale < self.cfg.baseline_epsilon:
                    print(f"Skipped {scene}: insufficient baseline {scale:.6f}")
                    continue
                ext[:, :3, 3] /= scale
            yield partial(self._load_sample, example, ctx_idx, tgt_idx, ext, intrinsics, scale)

    def _load_sample(self, example, ctx_idx, tgt_idx, ext, intrinsics, scale):
        """One view draw's sample with its frames decoded, or None where a
        frame has another shape than 360 x 640."""
        scene = example["key"]
        context_images = self._convert_images([example["images"][int(i)] for i in ctx_idx])
        target_images = self._convert_images([example["images"][int(i)] for i in tgt_idx])
        if context_images.shape[1:] != (360, 640, 3) or target_images.shape[1:] != (360, 640, 3):
            print(f"Skipped bad example {scene}: shapes {context_images.shape} / {target_images.shape}.")
            return None

        def views(indices, images):
            n = len(indices)
            return {
                "extrinsics": ext[indices],
                "intrinsics": intrinsics[indices],
                "image": images,
                "near": np.full((n,), NEAR / scale, np.float32),
                "far": np.full((n,), FAR / scale, np.float32),
                "index": indices.astype(np.int32),
            }

        return {"context": views(ctx_idx, context_images), "target": views(tgt_idx, target_images), "scene": scene}

    @staticmethod
    def _convert_images(images) -> np.ndarray:
        """JPEG bytes (uint8 tensors) -> uint8 (v, h, w, 3)."""
        return np.stack([decode_jpeg(np.asarray(image, np.uint8).tobytes()) for image in images])

    @property
    def data_stage(self) -> Stage:
        if self.cfg.overfit_to_scene is not None or self.stage == "val":
            return "test"
        return self.stage

    @cached_property
    def index(self) -> dict[str, Path]:
        merged = {}
        stages = ["test", "train"] if self.cfg.overfit_to_scene is not None else [self.data_stage]
        for data_stage in stages:
            for root in self.cfg.roots:
                root = Path(root)
                with (root / data_stage / "index.json").open() as f:
                    index = json.load(f)
                index = {k: root / data_stage / v for k, v in index.items()}
                assert not (set(merged) & set(index))
                merged.update(index)
        return merged

    def __len__(self) -> int:
        if isinstance(self.view_sampler, ViewSamplerEvaluation):
            return self.view_sampler.total_samples
        return len(self.index)
