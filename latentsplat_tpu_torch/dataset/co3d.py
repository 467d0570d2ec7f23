"""CO3Dv2 dataset reader (counterpart of latentsplat_tpu/dataset/co3d.py:
the same sequences, frames, cameras, random draws and examples).

Reads one category's gzipped `frame_annotations.jgz` (JSON) and the split
JSON of the stage (lists of [sequence_name, frame_number, image_path]),
converts each frame's PyTorch3D NDC camera to OpenCV extrinsics and
normalized intrinsics, skips examples with det(R) != 1, undersized,
missing or damaged images, resizes a sequence's frames to its smallest size and
applies the augmentation and crop shims. Frames are decoded by the port's C
decoder (`dataset.jpeg`), not PIL.
"""

from __future__ import annotations

import gzip
import json
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .jpeg import CorruptJPEGError, decode_jpeg
from .shims import _rescale_image, apply_crop_shim, shard_rows
from .types import DatasetCO3DCfg, RowShard, Stage
from .view_samplers import ViewSampler, ViewSamplerEvaluation


def _ndc_to_opencv(
    R_p3d: np.ndarray,          # (3, 3) PyTorch3D, row-major
    T_p3d: np.ndarray,          # (3,)
    focal: np.ndarray,          # (2,)
    principal: np.ndarray,      # (2,)
    intrinsics_format: str,
    image_size_hw: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """PyTorch3D NDC camera -> (c2w extrinsics 4x4, normalized K 3x3)."""
    h, w = image_size_hw
    focal = np.asarray(focal, np.float64).copy()
    principal = np.asarray(principal, np.float64).copy()
    size_wh = np.asarray([w, h], np.float64)

    if intrinsics_format == "ndc_norm_image_bounds":
        # Legacy format: scale per axis to the isotropic NDC convention.
        per_axis_scale = size_wh / size_wh.min()
        focal = focal * per_axis_scale
        principal = principal * per_axis_scale
    elif intrinsics_format != "ndc_isotropic":
        raise ValueError(f"Unknown intrinsics format: {intrinsics_format}")

    # PyTorch3D -> OpenCV: flip x and y, and transpose (row- to column-major).
    R = np.asarray(R_p3d, np.float64).copy()
    T = np.asarray(T_p3d, np.float64).copy()
    T[:2] *= -1
    R[:, :2] *= -1

    # NDC -> pixels.
    scale = size_wh.min() / 2.0
    principal_px = -principal * scale + size_wh / 2.0
    focal_px = focal * scale

    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = T
    c2w = np.linalg.inv(w2c).astype(np.float32)

    K = np.zeros((3, 3), np.float32)
    K[0, 0] = focal_px[0] / w
    K[1, 1] = focal_px[1] / h
    K[0, 2] = principal_px[0] / w
    K[1, 2] = principal_px[1] / h
    K[2, 2] = 1.0
    return c2w, K


class DatasetCO3D:
    def __init__(
        self,
        cfg: DatasetCO3DCfg,
        stage: Stage,
        view_sampler: ViewSampler,
        force_shuffle: bool = False,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.force_shuffle = force_shuffle
        self.path = Path(cfg.roots[0])
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.row_shard = RowShard()
        self.rng = np.random.default_rng(0)

        self.dataset = self._load_annotations()
        self.sequence_names = list(self.dataset.keys())

    def _load_annotations(self) -> Dict[str, List[dict]]:
        """sequence -> its frame annotations in frame order."""
        with gzip.open(self.path / self.cfg.scene / "frame_annotations.jgz", "rt") as f:
            frames = json.load(f)
        frame_map = {(x["sequence_name"], x["frame_number"]): x for x in frames}

        if self.stage in ("test", "val") or self.cfg.overfit_to_scene:
            split_json = self.cfg.eval_split_json
        else:
            split_json = self.cfg.train_split_json
        with open(split_json) as f:
            data_list = json.load(f)

        per_sequence: Dict[str, List[dict]] = {}
        for seq_name, frame_num, _ in data_list:
            if self.cfg.overfit_to_scene is None or self.cfg.overfit_to_scene == seq_name:
                per_sequence.setdefault(seq_name, []).append(frame_map[(seq_name, frame_num)])
        for seq_name in per_sequence:
            per_sequence[seq_name].sort(key=lambda fa: fa["frame_number"])
        return per_sequence

    def _camera(self, frame: dict) -> tuple[np.ndarray, np.ndarray]:
        vp = frame["viewpoint"]
        h, w = frame["image"]["size"]
        return _ndc_to_opencv(
            np.asarray(vp["R"], np.float64),
            np.asarray(vp["T"], np.float64),
            np.asarray(vp["focal_length"], np.float64),
            np.asarray(vp["principal_point"], np.float64),
            vp.get("intrinsics_format", "ndc_norm_image_bounds"),
            (h, w),
        )

    def _load_image(self, rel_path: str) -> Optional[np.ndarray]:
        """uint8 (h, w, 3), or None when the file is missing or damaged (as
        the JAX reader returns None on PIL's OSError); a valid JPEG of a mode
        the decoder does not take raises."""
        try:
            return decode_jpeg((self.path / rel_path).read_bytes())
        except (OSError, CorruptJPEGError):
            return None

    def _near_far(self, extrinsics: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The camera radius +- 8 (near at least 0.5), or the configured planes."""
        v = extrinsics.shape[0]
        if self.cfg.planes is None:
            radius = np.linalg.norm(extrinsics[:, :3, 3], axis=-1)
            near = np.clip(radius - 8.0, 0.5, None)
            far = radius + 8.0
            return near.astype(np.float32), far.astype(np.float32)
        near, far = self.cfg.planes
        return np.full((v,), near, np.float32), np.full((v,), far, np.float32)

    def __iter__(self):
        names = list(self.sequence_names)
        if (self.stage == "train" and not self.cfg.overfit_to_scene) or self.force_shuffle:
            self.rng.shuffle(names)
        if self.num_shards > 1:
            names = names[self.shard_index :: self.num_shards]

        # Each view draw whose frames pass the checks made without their
        # images is a row (`shard_rows`; under a row shard a frame that fails
        # to decode drops its row on its own rank alone).
        def candidates():
            for seq_name in names:
                frames = self.dataset[seq_name]
                try:
                    view_indices = self.view_sampler.sample(seq_name, len(frames), self.rng)
                except ValueError:
                    continue
                for view_index in view_indices:
                    cameras = [self._check_views(frames, idx) for idx in (view_index.context, view_index.target)]
                    if None not in cameras:
                        yield partial(self._make_example, seq_name, frames, view_index.context, view_index.target,
                                      cameras)

        augment = self.stage == "train" and self.cfg.augment
        for example in shard_rows(candidates(), self.row_shard, self.rng, augment):
            yield apply_crop_shim(example, tuple(self.cfg.image_shape))

    def _check_views(self, frames, indices):
        """(extrinsics, intrinsics) of the frames at `indices`, or None when
        one is too small or a camera is a reflection; reads no image."""
        selected = [frames[int(i)] for i in indices]
        for fr in selected:
            h, w = fr["image"]["size"]
            if h <= self.cfg.image_shape[0] or w <= self.cfg.image_shape[1]:
                return None
        cams = [self._camera(fr) for fr in selected]
        extrinsics = np.stack([c[0] for c in cams])
        intrinsics = np.stack([c[1] for c in cams])
        # Some sequences hold reflections (det(R) = -1).
        if not np.allclose(np.linalg.det(extrinsics[:, :3, :3]), 1.0, atol=1e-4):
            return None
        return extrinsics, intrinsics

    def _make_example(self, seq_name, frames, context_idx, target_idx, cameras):
        def views(indices, extrinsics, intrinsics):
            selected = [frames[int(i)] for i in indices]
            images = []
            for fr in selected:
                img = self._load_image(fr["image"]["path"])
                if img is None:
                    return None
                images.append(img)
            # Every frame at the smallest size among them.
            min_h = min(im.shape[0] for im in images)
            min_w = min(im.shape[1] for im in images)
            images = np.stack([
                im if im.shape[:2] == (min_h, min_w) else _rescale_image(im, (min_h, min_w)) for im in images
            ])
            near, far = self._near_far(extrinsics)
            return {
                "extrinsics": extrinsics.astype(np.float32),
                "intrinsics": intrinsics.astype(np.float32),
                "image": images,
                "near": near,
                "far": far,
                "index": np.asarray(indices, np.int32),
            }

        context = views(context_idx, *cameras[0])
        target = views(target_idx, *cameras[1])
        if context is None or target is None:
            return None
        return {"context": context, "target": target, "scene": seq_name}

    def __len__(self) -> int:
        if isinstance(self.view_sampler, ViewSamplerEvaluation):
            return self.view_sampler.total_samples
        return len(self.dataset)
