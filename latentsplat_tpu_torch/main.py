"""Command-line entry point (counterpart of latentsplat_tpu/main.py):

    python -m latentsplat_tpu_torch.main +experiment=re10k mode=train dataset.name=synthetic ...
    python -m latentsplat_tpu_torch.main +experiment=re10k mode=test \\
        checkpointing.load=outputs/<run>/checkpoints/step_00200000

Arguments are `key=value` overrides onto config/presets/main.yaml;
`+experiment=<name>` overlays config/presets/experiment/<name>.yaml. Each
run writes into `<output_dir>/<experiment>_<time>/`, and
`<output_dir>/latest-run` links to it. The command line always runs on the
card and exits with a message where there is none; `main(argv,
device="cpu")` runs on the CPU (tests).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

from .config import load_config


def parse_args(argv):
    experiment = None
    overrides = []
    for arg in argv:
        if arg.startswith("+experiment="):
            experiment = arg.split("=", 1)[1]
        elif "=" in arg:
            overrides.append(arg)
        else:
            raise SystemExit(f"unrecognized argument {arg!r} (use key=value)")
    return experiment, overrides


def main(argv=None, device=None) -> Path:
    """Run `mode` (train: fit then test; val; test) and return the run's
    output directory."""
    experiment, overrides = parse_args(argv if argv is not None else sys.argv[1:])
    if device is None and not torch.cuda.is_available():
        raise SystemExit("latentsplat_tpu_torch.main: no CUDA device found; this program runs on the GPU")
    cfg = load_config(experiment, overrides)

    run_name = time.strftime("%Y-%m-%d_%H-%M-%S")
    if experiment:
        run_name = f"{experiment}_{run_name}"
    output_dir = Path(cfg.output_dir) / run_name
    output_dir.mkdir(exist_ok=True, parents=True)
    latest = Path(cfg.output_dir) / "latest-run"
    try:
        if latest.is_symlink() or latest.exists():
            latest.unlink()
        latest.symlink_to(run_name)
    except OSError:
        pass
    print(f"outputs -> {output_dir}")

    from .training.checkpointing import load_checkpoint, resolve_checkpoint_uri
    from .training.trainer import Trainer

    trainer = Trainer(cfg, output_dir, device=device)
    if cfg.mode == "train":
        state = trainer.fit()
        trainer.test(state)
    elif cfg.mode in ("val", "test"):
        if cfg.checkpointing.load is None:
            raise SystemExit(f"{cfg.mode} mode needs checkpointing.load")
        restored = load_checkpoint(resolve_checkpoint_uri(cfg.checkpointing.load), device="cpu")
        if cfg.mode == "val":
            trainer.validate_params(restored["generator"])
        else:
            trainer.test(restored["generator"], name=cfg.wandb.name)
    else:
        raise SystemExit(f"unknown mode {cfg.mode!r}")
    return output_dir


if __name__ == "__main__":
    main()
