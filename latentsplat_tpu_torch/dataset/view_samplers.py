"""View samplers: choose the context and target frame indices of a scene
(counterpart of latentsplat_tpu/dataset/view_samplers.py, same seeds and
draws).

  * bounded - context gap curriculum with warm-up schedules, the circular
    camera modulo, and every frame between the context views at test time.
  * arbitrary - random (or fixed) context and random targets.
  * evaluation - a frozen JSON index {scene: {context: [...], target: [...]}}.
  * all - every frame as context and as target.

Host-side numpy; the draws come from the dataset's numpy Generator.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Literal, NamedTuple, Optional

import numpy as np


class ViewIndex(NamedTuple):
    context: np.ndarray  # (num_context_views,) int
    target: np.ndarray   # (num_target_views,) int


@dataclass
class ViewSamplerBoundedCfg:
    name: Literal["bounded"] = "bounded"
    num_context_views: int = 2
    num_target_views: int = 1
    min_distance_between_context_views: int = 2
    max_distance_between_context_views: int = 6
    max_distance_to_context_views: int = 0
    context_gap_warm_up_steps: int = 0
    target_gap_warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 2
    initial_max_distance_between_context_views: int = 6
    initial_max_distance_to_context_views: int = 0


@dataclass
class ViewSamplerArbitraryCfg:
    name: Literal["arbitrary"] = "arbitrary"
    num_context_views: int = 2
    num_target_views: int = 1
    context_views: Optional[List[int]] = None
    target_views: Optional[List[int]] = None


@dataclass
class ViewSamplerEvaluationCfg:
    name: Literal["evaluation"] = "evaluation"
    index_path: str = ""
    num_context_views: int = 2


@dataclass
class ViewSamplerAllCfg:
    name: Literal["all"] = "all"


class ViewSampler:
    def __init__(self, cfg, stage, is_overfitting, cameras_are_circular, step_tracker):
        self.cfg = cfg
        self.stage = stage
        self.is_overfitting = is_overfitting
        self.cameras_are_circular = cameras_are_circular
        self.step_tracker = step_tracker

    @property
    def global_step(self) -> int:
        return self.step_tracker.get_step() if self.step_tracker is not None else 0

    def sample(self, scene: str, num_views: int, rng: np.random.Generator) -> list[ViewIndex]:
        raise NotImplementedError

    @property
    def num_context_views(self) -> int:
        raise NotImplementedError

    @property
    def num_target_views(self) -> int:
        raise NotImplementedError


class ViewSamplerBounded(ViewSampler):
    def _schedule(self, initial: int, final: int, steps: int) -> int:
        fraction = self.global_step / steps
        return min(initial + int((final - initial) * fraction), final)

    def sample(self, scene, num_views, rng):
        cfg = self.cfg
        if self.stage == "test":
            max_gap = min_gap = cfg.max_distance_between_context_views
        elif cfg.context_gap_warm_up_steps > 0:
            max_gap = self._schedule(
                cfg.initial_max_distance_between_context_views,
                cfg.max_distance_between_context_views,
                cfg.context_gap_warm_up_steps,
            )
            min_gap = self._schedule(
                cfg.initial_min_distance_between_context_views,
                cfg.min_distance_between_context_views,
                cfg.context_gap_warm_up_steps,
            )
        else:
            max_gap = cfg.max_distance_between_context_views
            min_gap = cfg.min_distance_between_context_views

        if not self.cameras_are_circular:
            max_gap = min(num_views - 1, max_gap)

        if self.stage != "test" and cfg.target_gap_warm_up_steps > 0:
            max_target_gap = self._schedule(
                cfg.initial_max_distance_to_context_views,
                cfg.max_distance_to_context_views,
                cfg.target_gap_warm_up_steps,
            )
        else:
            max_target_gap = cfg.max_distance_to_context_views

        if max_gap < min_gap:
            raise ValueError("Example does not have enough frames!")
        context_gap = int(rng.integers(min_gap, max_gap + 1))

        high = num_views if self.cameras_are_circular else num_views - context_gap
        index_context_left = int(rng.integers(0, high))
        if self.stage == "test":
            index_context_left = 0
        index_context_right = index_context_left + context_gap

        if self.is_overfitting:
            index_context_left = 0
            index_context_right = max_gap

        index_target_left = index_context_left - max_target_gap
        index_target_right = index_context_right + max_target_gap
        if not self.cameras_are_circular:
            index_target_left = max(0, index_target_left)
            index_target_right = min(num_views - 1, index_target_right)

        if self.stage == "test":
            index_target = np.arange(index_target_left, index_target_right + 1)
        else:
            index_target = rng.integers(
                index_target_left, index_target_right + 1, size=(cfg.num_target_views,)
            )

        if self.cameras_are_circular:
            index_target = index_target % num_views
            index_context_right = index_context_right % num_views

        return [
            ViewIndex(np.asarray([index_context_left, index_context_right]), np.asarray(index_target))
        ]

    @property
    def num_context_views(self) -> int:
        return 2

    @property
    def num_target_views(self) -> int:
        return self.cfg.num_target_views


class ViewSamplerArbitrary(ViewSampler):
    def sample(self, scene, num_views, rng):
        cfg = self.cfg
        if cfg.context_views is not None:
            context = np.asarray(cfg.context_views)
            if len(context) != cfg.num_context_views:
                raise ValueError(f"context_views {cfg.context_views} is not num_context_views long")
        else:
            context = rng.integers(0, num_views, size=(cfg.num_context_views,))
        if cfg.target_views is not None:
            target = np.asarray(cfg.target_views)
            if len(target) != cfg.num_target_views:
                raise ValueError(f"target_views {cfg.target_views} is not num_target_views long")
        else:
            target = rng.integers(0, num_views, size=(cfg.num_target_views,))
        return [ViewIndex(np.asarray(context), np.asarray(target))]

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return self.cfg.num_target_views


class ViewSamplerEvaluation(ViewSampler):
    def __init__(self, cfg, stage, is_overfitting, cameras_are_circular, step_tracker):
        super().__init__(cfg, stage, is_overfitting, cameras_are_circular, step_tracker)
        raw = json.loads(Path(cfg.index_path).read_text())
        # {scene: null | {context: [...], target: [...]} | [entries...]}
        self.index = {}
        for scene, entry in raw.items():
            if entry is None:
                continue
            entries = entry if isinstance(entry, list) else [entry]
            self.index[scene] = [
                ViewIndex(np.asarray(e["context"]), np.asarray(e["target"])) for e in entries
            ]

    def sample(self, scene, num_views, rng):
        return self.index.get(scene, [])

    @property
    def total_samples(self) -> int:
        return sum(len(v) for v in self.index.values())

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return 1


class ViewSamplerAll(ViewSampler):
    def sample(self, scene, num_views, rng):
        all_frames = np.arange(num_views)
        return [ViewIndex(all_frames, all_frames)]

    @property
    def num_context_views(self) -> int:
        return 0

    @property
    def num_target_views(self) -> int:
        return 0


VIEW_SAMPLERS = {
    "bounded": ViewSamplerBounded,
    "arbitrary": ViewSamplerArbitrary,
    "evaluation": ViewSamplerEvaluation,
    "all": ViewSamplerAll,
}


def get_view_sampler(cfg, stage, overfit: bool, cameras_are_circular: bool, step_tracker) -> ViewSampler:
    return VIEW_SAMPLERS[cfg.name](cfg, stage, overfit, cameras_are_circular, step_tracker)
