"""Evaluation index generation (counterpart of
latentsplat_tpu/evaluation/evaluation_index_generator.py).

For re10k-style scenes, each context view in a random order looks for a
partner at least `min_context_distance` frames away whose mutual ray
overlap lies in [min_context_overlap, max_context_overlap]; the targets are
drawn between the pair (`intra_context`) or beside it. For co3d-style
circular scenes, pairs are drawn by frame distance, wrapping around. The
index is written as the JSON that the evaluation view sampler reads:
{scene: [{"context": [...], "target": [...]}, ...]}. Randomness comes from
the caller's numpy generator, so the same cameras and seed give the same
index as the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..geometry import get_world_rays, project_rays, sample_image_grid
from .types import IndexEntry


@dataclass
class EvaluationIndexGeneratorCfg:
    num_target_views: int
    min_context_overlap: float
    max_context_overlap: float
    min_context_distance: int
    max_context_distance: int
    max_target_distance: int
    intra_context: bool
    output_path: Path
    save_previews: bool = False
    seed: int = 0
    num_context_pairs_per_scene: int = 1


@dataclass
class CO3DEvaluationIndexGeneratorCfg:
    num_target_views: int
    min_context_distance: int
    max_context_distance: int
    intra_context: bool
    output_path: Path
    save_previews: bool = False
    seed: int = 0
    num_context_pairs_per_scene: int = 1


def _mutual_overlap(
    ext_a: torch.Tensor, intr_a: torch.Tensor, ext_b: torch.Tensor, intr_b: torch.Tensor,
    image_shape: tuple[int, int],
) -> tuple[float, float]:
    """The share of view a's pixel rays that project into image b, and the
    share of b's that project into a."""
    xy, _ = sample_image_grid(image_shape, device=ext_a.device)
    xy = xy.reshape(-1, 2)
    origins_a, dirs_a = get_world_rays(xy, ext_a, intr_a)
    origins_b, dirs_b = get_world_rays(xy, ext_b, intr_b)
    onto_b = project_rays(origins_a, dirs_a, ext_b, intr_b)
    onto_a = project_rays(origins_b, dirs_b, ext_a, intr_a)
    return float(onto_a["overlaps_image"].float().mean()), float(onto_b["overlaps_image"].float().mean())


def generate_evaluation_index_for_scene(
    cfg: EvaluationIndexGeneratorCfg,
    extrinsics: np.ndarray,   # (v, 4, 4)
    intrinsics: np.ndarray,   # (v, 3, 3)
    image_shape: tuple[int, int],
    rng: np.random.Generator,
    device=None,
) -> List[IndexEntry]:
    """Ray-overlap-filtered context pairs and their target views for one
    scene; the rays are cast on `device` (the CPU by default)."""
    v = extrinsics.shape[0]
    ext = torch.as_tensor(np.asarray(extrinsics, np.float32), device=device)
    intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
    views: List[IndexEntry] = []

    for context_index in rng.permutation(v):
        context_index = int(context_index)
        valid_indices = []
        for step in (1, -1):
            current_index = context_index + step * cfg.min_context_distance
            while 0 <= current_index < v:
                overlap = min(_mutual_overlap(
                    ext[context_index], intr[context_index], ext[current_index], intr[current_index],
                    tuple(image_shape),
                ))
                delta = abs(current_index - context_index)
                if cfg.min_context_overlap <= overlap <= cfg.max_context_overlap:
                    valid_indices.append(current_index)
                if overlap < cfg.min_context_overlap or delta > cfg.max_context_distance:
                    break
                current_index += step

        if not valid_indices:
            continue
        chosen = valid_indices[int(rng.integers(len(valid_indices)))]
        context_left = min(chosen, context_index)
        context_right = max(chosen, context_index)

        if cfg.intra_context:
            target_views = np.arange(context_left, context_right + 1)
        else:
            target_views = np.concatenate([
                np.arange(max(context_left - cfg.max_target_distance, 0), context_left),
                np.arange(context_right + 1, min(context_right + cfg.max_target_distance + 1, v)),
            ])
        if len(target_views) < cfg.num_target_views:
            continue
        target_views = rng.permutation(target_views)[: cfg.num_target_views]
        views.append(IndexEntry(
            context=(context_left, context_right), target=tuple(int(t) for t in np.sort(target_views)),
        ))
        if len(views) == cfg.num_context_pairs_per_scene:
            break
    return views


def generate_co3d_evaluation_index_for_scene(
    cfg: CO3DEvaluationIndexGeneratorCfg,
    num_views: int,
    rng: np.random.Generator,
) -> List[IndexEntry]:
    """Context pairs by frame distance on a circular camera path, and their
    targets, for one scene."""
    v = num_views
    views: List[IndexEntry] = []
    context_indices = rng.permutation(v)[: cfg.num_context_pairs_per_scene]
    offsets = np.arange(cfg.min_context_distance, cfg.max_context_distance)
    offsets = np.concatenate([-offsets, offsets])

    for context_index in context_indices:
        partner = int(context_index) + int(offsets[rng.integers(len(offsets))])
        context_left, context_right = sorted((int(context_index), partner))

        if cfg.intra_context:
            target_views = np.arange(context_left, context_right + 1)
        elif context_left < 0 and context_right < v:
            target_views = np.arange(context_right + 1, context_left % v)
        elif context_left >= 0 and context_right < v:
            target_views = np.concatenate([np.arange(0, context_left), np.arange(context_right, v)])
        elif context_left >= 0 and context_right >= v:
            target_views = np.arange(context_right % v + 1, context_left)
        else:
            raise ValueError("Impossible context window")

        if len(target_views) < cfg.num_target_views:
            continue
        target_views = np.sort(rng.permutation(target_views)[: cfg.num_target_views])
        # Wrapped around only after the sort, which keeps the order along the path.
        views.append(IndexEntry(
            context=(context_left % v, context_right % v), target=tuple(int(t) % v for t in target_views),
        ))
    return views


def save_index(index: Dict[str, List[IndexEntry]], output_path: Path) -> None:
    output_path = Path(output_path)
    output_path.mkdir(exist_ok=True, parents=True)
    with (output_path / "evaluation_index.json").open("w") as f:
        json.dump({k: [v.to_dict() for v in entries] for k, entries in index.items()}, f)


def load_index(path: Path) -> Dict[str, Optional[List[IndexEntry]]]:
    """Read an evaluation_index.json; a scene may also hold a single
    {context, target} entry or null, as the reference's indices do."""
    with Path(path).open() as f:
        raw = json.load(f)
    out: Dict[str, Optional[List[IndexEntry]]] = {}
    for scene, entries in raw.items():
        if entries is None:
            out[scene] = None
        elif isinstance(entries, dict):
            out[scene] = [IndexEntry.from_dict(entries)]
        else:
            out[scene] = [IndexEntry.from_dict(e) for e in entries]
    return out
