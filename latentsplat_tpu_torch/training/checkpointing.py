"""Checkpoints: save, find, load and resume (counterpart of
latentsplat_tpu/training/checkpointing.py, with torch.save in place of
orbax).

A checkpoint is one file, `step_{step:08d}`, holding everything a resumed
run needs: the step, the generator's, discriminator's and LPIPS'
state_dicts, both optimizers' states (each group's count, mu and nu), the
loss-spike guard's EMA and skip count. `latest` names the newest file.
Both are written to a temporary name and renamed, so a reader never sees a
half-written file. Loading with `resume` restores all of it; loading
without takes only the generator's weights.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch


def _state_dict(state) -> dict:
    return {
        "generator": state.model.state_dict(),
        "discriminator": state.discriminator.state_dict() if state.discriminator is not None else None,
        "lpips": state.lpips.state_dict(),
        "opt_gen": state.opt_gen.state,
        "opt_disc": state.opt_disc.state if state.opt_disc is not None else None,
        "gen_loss_ema": state.gen_loss_ema,
        "spike_skip_count": state.spike_skip_count,
    }


def _write_atomically(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.tmp")
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(state, directory: Path, step: int) -> Path:
    """Write `state` (a training.step.TrainState) and `step` to
    directory/step_<step>, and point `latest` at it."""
    directory = Path(directory)
    directory.mkdir(exist_ok=True, parents=True)
    path = directory / f"step_{step:08d}"
    _write_atomically(path, lambda tmp: torch.save({"step": int(step), **_state_dict(state)}, tmp))
    _write_atomically(directory / "latest", lambda tmp: tmp.write_text(path.name))
    return path


def latest_checkpoint(directory: Path) -> Optional[Path]:
    directory = Path(directory)
    pointer = directory / "latest"
    if pointer.exists():
        path = directory / pointer.read_text().strip()
        if path.exists():
            return path
    steps = sorted(directory.glob("step_*"))
    return steps[-1] if steps else None


def _copy_into(target: dict, source: dict) -> None:
    for key, value in source.items():
        if isinstance(value, dict):
            _copy_into(target[key], value)
        else:
            target[key] = value.to(target[key].device)


def load_checkpoint(path: Path, target=None, device=None) -> dict:
    """The checkpoint's contents, tensors on `device` (default: where they
    were saved). With `target` (a TrainState of the same configuration),
    also restores every tensor of it in place: networks, optimizer states
    and the spike guard's."""
    restored = torch.load(Path(path), map_location=device, weights_only=True)
    if target is not None:
        target.model.load_state_dict(restored["generator"])
        target.lpips.load_state_dict(restored["lpips"])
        if target.discriminator is not None:
            target.discriminator.load_state_dict(restored["discriminator"])
        for opt, saved in ((target.opt_gen, restored["opt_gen"]), (target.opt_disc, restored["opt_disc"])):
            if opt is not None:
                assert set(saved) == set(opt.state), (set(saved), set(opt.state))
                _copy_into(opt.state, saved)
        for key in ("gen_loss_ema", "spike_skip_count"):
            if getattr(target, key) is not None:
                setattr(target, key, restored[key].to(getattr(target, key).device))
    return restored


def load_generator_weights(path: Path, model: torch.nn.Module) -> torch.nn.Module:
    """Weights-only load into `model` (a LatentSplat): every tensor the
    checkpoint has for it; a key the checkpoint lacks keeps its fresh value."""
    restored = torch.load(Path(path), map_location="cpu", weights_only=True)
    source = restored.get("generator", restored)
    merged = {k: source.get(k, v) for k, v in model.state_dict().items()}
    model.load_state_dict(merged)
    return model


def resolve_checkpoint_uri(uri: str) -> Path:
    """Plain paths pass through; `wandb://run_id:version` URIs need the
    wandb API and a network, which the port does not use."""
    if uri.startswith("wandb://"):
        raise NotImplementedError(f"cannot fetch {uri}: download the checkpoint and pass its path")
    return Path(uri)
