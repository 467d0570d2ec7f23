"""Run loggers (counterpart of latentsplat_tpu/training/logger.py): a local
logger that appends scalars to metrics.jsonl and writes images as
{key}/{step:0>6}.png, and an optional wandb logger that falls back to the
local one when wandb is missing or fails to start.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Dict

import numpy as np

from ..misc.image_io import save_image, save_video

LOG_PATH = Path("outputs/local")


class LocalLogger:
    def __init__(self, output_dir: Path = LOG_PATH, clear: bool = True):
        self.output_dir = Path(output_dir)
        if clear and self.output_dir.exists():
            shutil.rmtree(self.output_dir, ignore_errors=True)
        self.output_dir.mkdir(exist_ok=True, parents=True)
        self._scalars = (self.output_dir / "metrics.jsonl").open("a")

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._scalars.write(json.dumps(record) + "\n")
        self._scalars.flush()

    def log_image(self, key: str, image: np.ndarray, step: int) -> None:
        save_image(image, self.output_dir / key / f"{step:0>6}.png")

    def log_video(self, key: str, frames, step: int, fps: int = 30) -> None:
        save_video(frames, self.output_dir / key / f"{step:0>6}.mp4", fps=fps)

    def close(self) -> None:
        self._scalars.close()


class WandbLogger:
    """wandb beside the local logger; local only when wandb is missing or
    its run does not start."""

    def __init__(self, cfg, output_dir: Path):
        try:
            import wandb

            self._wandb = wandb
            self.run = wandb.init(
                project=cfg.project, entity=cfg.entity or None, name=cfg.name, mode=cfg.mode,
                tags=list(cfg.tags) or None,
            )
        except Exception:
            self._wandb = None
        self.local = LocalLogger(output_dir, clear=False)

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in scalars.items()}, step=step)
        self.local.log_scalars(scalars, step)

    def log_image(self, key: str, image: np.ndarray, step: int) -> None:
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Image(np.asarray(image))}, step=step)
        self.local.log_image(key, image, step)

    def log_video(self, key: str, frames, step: int, fps: int = 30) -> None:
        self.local.log_video(key, frames, step, fps)

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        self.local.close()


def get_logger(wandb_cfg, output_dir: Path):
    if wandb_cfg is not None and wandb_cfg.activated and wandb_cfg.mode != "disabled":
        return WandbLogger(wandb_cfg, output_dir)
    return LocalLogger(output_dir)
