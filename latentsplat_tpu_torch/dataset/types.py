"""Dataset and loader configs (counterpart of latentsplat_tpu/dataset/types.py).

Example layout (numpy on the host; the trainer moves it to the device):
  example = {
    "context": {"extrinsics" (v, 4, 4), "intrinsics" (v, 3, 3), "image" (v, h, w, 3),
                "near" (v,), "far" (v,), "index" (v,)},
    "target":  {... the same with the target views ...},
    "scene":   str,
  }
A batch stacks examples on a leading axis b; "scene" becomes a list.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Optional, Union

from .view_samplers import (
    ViewSamplerAllCfg,
    ViewSamplerArbitraryCfg,
    ViewSamplerBoundedCfg,
    ViewSamplerEvaluationCfg,
)

Stage = Literal["train", "val", "test"]


@dataclass(frozen=True)
class RowShard:
    """The rows of each global batch that one data-parallel rank reads: of
    every `period` consecutive examples in the one-process order, those at
    positions start .. stop - 1. A dataset with a row shard still makes
    every example's random draws (view indices, flips), in order, but
    decodes only its own rows, and drops a pass's last, incomplete period
    (`shims.shard_rows`). The default keeps every row."""

    start: int = 0
    stop: int = 1
    period: int = 1

    @property
    def whole(self) -> bool:
        return self.period == 1

    def keeps(self, position: int) -> bool:
        return self.start <= position % self.period < self.stop

ViewSamplerCfg = Union[
    ViewSamplerBoundedCfg,
    ViewSamplerArbitraryCfg,
    ViewSamplerEvaluationCfg,
    ViewSamplerAllCfg,
]


@dataclass
class DatasetCfgCommon:
    image_shape: List[int] = field(default_factory=lambda: [256, 256])
    background_color: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    cameras_are_circular: bool = False
    overfit_to_scene: Optional[str] = None
    view_sampler: ViewSamplerCfg = field(default_factory=ViewSamplerBoundedCfg)


@dataclass
class DatasetRE10kCfg(DatasetCfgCommon):
    name: Literal["re10k"] = "re10k"
    roots: List[str] = field(default_factory=lambda: ["datasets/re10k"])
    baseline_epsilon: float = 1e-3
    max_fov: float = 100.0
    make_baseline_1: bool = True
    augment: bool = True


@dataclass
class DatasetCO3DCfg(DatasetCfgCommon):
    name: Literal["co3d"] = "co3d"
    roots: List[str] = field(default_factory=lambda: ["datasets/"])
    scene: str = "hydrant"                      # CO3D category
    planes: Optional[List[float]] = None        # fixed [near, far], else radius +- 8
    train_split_json: str = "assets/dataset_splits/co3d_hydrant_train.json"
    eval_split_json: str = "assets/dataset_splits/co3d_hydrant_eval.json"
    make_baseline_1: bool = True
    augment: bool = True
    baseline_epsilon: float = 1e-3
    max_fov: float = 100.0


@dataclass
class DatasetSyntheticCfg(DatasetCfgCommon):
    """Procedural scenes of colored Gaussian blobs, for runs without mounted
    data (the JAX package's own dataset; not in the original latentSplat)."""

    name: Literal["synthetic"] = "synthetic"
    num_scenes: int = 64
    num_frames: int = 24
    seed: int = 0


DatasetCfg = Union[DatasetRE10kCfg, DatasetCO3DCfg, DatasetSyntheticCfg]


@dataclass
class DataLoaderStageCfg:
    batch_size: int = 2
    num_workers: int = 4
    persistent_workers: bool = True
    seed: Optional[int] = None


@dataclass
class DataLoaderCfg:
    train: DataLoaderStageCfg = field(default_factory=DataLoaderStageCfg)
    test: DataLoaderStageCfg = field(
        default_factory=lambda: DataLoaderStageCfg(batch_size=1, num_workers=2)
    )
    val: DataLoaderStageCfg = field(
        default_factory=lambda: DataLoaderStageCfg(batch_size=1, num_workers=1)
    )
