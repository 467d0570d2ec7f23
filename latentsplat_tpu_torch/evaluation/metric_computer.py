"""Scores of rendered PNG directories (counterpart of
latentsplat_tpu/evaluation/metric_computer.py).

For each evaluation example (batch size 1) the frames of every method are
read from <method.path>/<scene>/<context indices>/color/<index>.png (zlib,
no PIL) and scored against the ground truth: PSNR and SSIM always, LPIPS
and DISTS when their networks are given. The metrics run on `device`, the
card unless the caller names another. Running means are printed as a
table; side-by-side comparisons (and their videos) are written on request.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..misc.image_io import load_image, save_image, save_video
from ..visualization.annotation import add_label
from ..visualization.layout import add_border, hcat
from .metrics import compute_dists, compute_lpips, compute_psnr, compute_ssim

METRIC_NAMES = ("psnr", "lpips", "dists", "ssim")


@dataclass
class MethodCfg:
    name: str
    key: str
    path: Path


@dataclass
class EvaluationCfg:
    methods: List[MethodCfg]
    side_by_side_path: Optional[Path] = None
    animate_side_by_side: bool = False


def _format_table(rows: List[tuple], headers: tuple) -> str:
    table = [tuple(str(c) for c in headers)] + [tuple(str(c) for c in r) for r in rows]
    widths = [max(len(r[i]) for r in table) for i in range(len(headers))]
    lines = []
    for j, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


class MetricComputer:
    """Call `step(batch)` per evaluation example, then `save_scores(path)`.
    `lpips_fn` and `dists_fn` take two (n, h, w, 3) tensors on `device`."""

    def __init__(self, cfg: EvaluationCfg, lpips_fn=None, dists_fn=None, device=None):
        self.cfg = cfg
        self.lpips_fn = lpips_fn
        self.dists_fn = dists_fn
        self.device = torch.device("cuda" if device is None else device)
        self.scores: Dict[str, Dict[str, Dict[str, float]]] = {m: {} for m in METRIC_NAMES}
        self._running: Dict[str, float] = {}
        self._running_steps = 0
        self._step_idx = 0

    def step(self, batch: dict, verbose: bool = True) -> Optional[dict]:
        """batch = {"scene": str, "context": {"index"}, "target": {"index",
        "image" (..., v, h, w, 3)}} in numpy; returns {metric_key: score},
        or None when a method has no frames for the scene."""
        scene = batch["scene"]
        context_index_str = "_".join(str(int(i)) for i in np.sort(np.asarray(batch["context"]["index"]).reshape(-1)))
        target_index = np.asarray(batch["target"]["index"]).reshape(-1)
        rgb_gt = np.asarray(batch["target"]["image"])
        rgb_gt = rgb_gt.reshape(-1, *rgb_gt.shape[-3:])

        all_images = {}
        for method in self.cfg.methods:
            frame_dir = Path(method.path) / scene / context_index_str / "color"
            try:
                all_images[method.key] = np.stack([load_image(frame_dir / f"{int(i):0>6}.png") for i in target_index])
            except FileNotFoundError:
                print(f'Skipping "{scene}".')
                return None

        all_metrics = {}
        gt = torch.from_numpy(np.ascontiguousarray(rgb_gt, np.float32)).to(self.device)
        with torch.no_grad():
            for key, images in all_images.items():
                pr = torch.from_numpy(images).to(self.device)
                values = {
                    "psnr": float(compute_psnr(gt, pr).mean()),
                    "ssim": float(compute_ssim(gt, pr).mean()),
                }
                if self.lpips_fn is not None:
                    values["lpips"] = float(compute_lpips(gt, pr, self.lpips_fn).mean())
                if self.dists_fn is not None:
                    values["dists"] = float(compute_dists(gt, pr, self.dists_fn).mean())
                for metric, score in values.items():
                    self.scores[metric].setdefault(scene, {})[key] = score
                    all_metrics[f"{metric}_{key}"] = score

        self._update_running(all_metrics)
        if verbose:
            print(self._preview_table())
        if self.cfg.side_by_side_path is not None:
            self._save_side_by_side(rgb_gt, all_images, scene, context_index_str, target_index)
        self._step_idx += 1
        return all_metrics

    def _update_running(self, metrics: Dict[str, float]) -> None:
        if not self._running:
            self._running = dict(metrics)
            self._running_steps = 1
        else:
            s = self._running_steps
            self._running = {k: ((s * v) + metrics[k]) / (s + 1) for k, v in self._running.items() if k in metrics}
            self._running_steps += 1

    def _preview_table(self) -> str:
        rows = []
        for method in self.cfg.methods:
            row = [
                f"{self._running[f'{metric}_{method.key}']:.3f}" if f"{metric}_{method.key}" in self._running else "-"
                for metric in METRIC_NAMES
            ]
            rows.append((method.key, *row))
        return _format_table(rows, ("Method", "PSNR (dB)", "LPIPS", "DISTS", "SSIM"))

    def _save_side_by_side(self, gt_images, all_images, scene, context_index_str, target_index) -> None:
        scene_key = f"{self._step_idx:0>6}_{scene}"
        out_root = Path(self.cfg.side_by_side_path) / scene_key / context_index_str
        label = f"Scene {scene} (frames {int(target_index[0])} to {int(target_index[-1])})"
        frames = []
        for i, true_index in enumerate(target_index):
            row = [add_label(gt_images[i], "Ground Truth")]
            row += [add_label(all_images[method.key][i], method.name) for method in self.cfg.methods]
            image = add_border(add_label(hcat(*row), label, font_size=16))
            save_image(image, out_root / f"{int(true_index):0>6}.png")
            frames.append(image)
        if self.cfg.animate_side_by_side:
            save_video(frames, Path(self.cfg.side_by_side_path) / "videos" / f"{scene_key}.mp4")

    def save_scores(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with path.open("w") as f:
            json.dump(self.scores, f, indent=2)

    def mean_scores(self) -> Dict[str, Dict[str, float]]:
        """{metric: {method_key: mean over scenes}}."""
        out: Dict[str, Dict[str, float]] = {}
        for metric, per_scene in self.scores.items():
            sums: Dict[str, List[float]] = {}
            for scene_scores in per_scene.values():
                for key, v in scene_scores.items():
                    sums.setdefault(key, []).append(v)
            out[metric] = {k: float(np.mean(v)) for k, v in sums.items()}
        return out
