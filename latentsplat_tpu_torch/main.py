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

Training is data-parallel over `trainer.num_devices` ranks (None: every
visible card). More than one spawns a process per rank, rank r on cuda:r
over NCCL (on the CPU: that many CPU ranks over gloo); under torchrun
(RANK, WORLD_SIZE, LOCAL_RANK set) each process joins the group torchrun
describes instead, on cuda:LOCAL_RANK. Asking for more cards than are
visible raises. Validation and test run in one process (rank 0).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .config import load_config
from .parallel.mesh import destroy_mesh, make_mesh, single_mesh, spawn, torchrun_env


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


def _make_run_dir(cfg, experiment) -> Path:
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
    return output_dir


def num_ranks(cfg, device) -> int:
    """The ranks `trainer.num_devices` asks for: None is every visible card
    (one rank on the CPU); more cards than are visible raise."""
    n = cfg.trainer.num_devices
    if device is not None and torch.device(device).type == "cpu":
        return 1 if n is None else n
    visible = torch.cuda.device_count()
    n = visible if n is None else n
    if n > visible:
        raise ValueError(f"trainer.num_devices={n} asks for more cards than the {visible} visible")
    return n


def _train(mesh, cfg, output_dir: Path) -> None:
    """fit on every rank, then test on rank 0 alone: once fit has written
    its last checkpoint every rank leaves the group, so that no rank waits
    in a collective, under the group's timeout, while rank 0 tests."""
    from .training.trainer import Trainer

    trainer = Trainer(cfg, output_dir, mesh=mesh)
    state = trainer.fit()
    destroy_mesh(mesh)
    if mesh.is_main:
        trainer.mesh = single_mesh(mesh.device)
        trainer.test(state)


def main(argv=None, device=None) -> Path:
    """Run `mode` (train: fit then test; val; test) and return the run's
    output directory."""
    experiment, overrides = parse_args(argv if argv is not None else sys.argv[1:])
    if device is None and not torch.cuda.is_available():
        raise SystemExit("latentsplat_tpu_torch.main: no CUDA device found; this program runs on the GPU")
    cfg = load_config(experiment, overrides)

    env = torchrun_env()
    if env is not None and env["world_size"] > 1:
        return _join_torchrun(env, cfg, experiment, device)
    if cfg.mode == "train":
        n = num_ranks(cfg, device)
        output_dir = _make_run_dir(cfg, experiment)
        if n > 1:
            on_cpu = device is not None and torch.device(device).type == "cpu"
            devices = ["cpu"] * n if on_cpu else [f"cuda:{r}" for r in range(n)]
            spawn(_train, devices, "gloo" if on_cpu else "nccl", (cfg, output_dir))
        else:
            _train(single_mesh("cuda" if device is None else device), cfg, output_dir)
        return output_dir
    output_dir = _make_run_dir(cfg, experiment)
    _evaluate(cfg, output_dir, device)
    return output_dir


def _evaluate(cfg, output_dir: Path, device) -> None:
    from .training.checkpointing import load_checkpoint, resolve_checkpoint_uri
    from .training.trainer import Trainer

    if cfg.mode not in ("val", "test"):
        raise SystemExit(f"unknown mode {cfg.mode!r}")
    if cfg.checkpointing.load is None:
        raise SystemExit(f"{cfg.mode} mode needs checkpointing.load")
    trainer = Trainer(cfg, output_dir, device=device)
    restored = load_checkpoint(resolve_checkpoint_uri(cfg.checkpointing.load), device="cpu")
    if cfg.mode == "val":
        trainer.validate_params(restored["generator"])
    else:
        trainer.test(restored["generator"], name=cfg.wandb.name)


def _join_torchrun(env: dict, cfg, experiment, device) -> Path:
    """One rank of a torchrun launch: join its group (cuda:LOCAL_RANK over
    NCCL, or the CPU over gloo), train, and return rank 0's run directory;
    val and test modes run on rank 0 alone, after every rank has left the
    group."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    devices = ["cpu"] * env["world_size"] if on_cpu else [
        f"cuda:{r % env['local_world_size']}" for r in range(env["world_size"])
    ]
    mesh = make_mesh(devices, env["rank"], "gloo" if on_cpu else "nccl", "env://",
                     local_rank=env["local_rank"], local_world_size=env["local_world_size"])
    try:
        names = [_make_run_dir(cfg, experiment) if mesh.is_main else None]
        dist.broadcast_object_list(names, src=0, group=mesh.group)
        if cfg.mode == "train":
            _train(mesh, cfg, names[0])
    finally:
        destroy_mesh(mesh)
    if cfg.mode != "train" and mesh.is_main:
        _evaluate(cfg, names[0], devices[0])
    return names[0]


if __name__ == "__main__":
    main()
