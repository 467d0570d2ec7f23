"""Scores of rendered PNG directories against a dataset's ground truth
(counterpart of latentsplat_tpu/scripts/compute_metrics.py):

    python -m latentsplat_tpu_torch.scripts.compute_metrics +experiment=re10k \\
        'evaluation.methods=[{name: Ours, key: ours, path: outputs/test/ours}]' \\
        evaluation.output_metrics_path=outputs/metrics.json \\
        'dataset.view_sampler={name: evaluation, index_path: outputs/evaluation_index/evaluation_index.json}'

Every example of the test stage (batch size 1) goes through the
`MetricComputer` (PSNR and SSIM); the per-scene scores are written to
`evaluation.output_metrics_path` and their means beside it as
<name>.mean.json. `evaluation.side_by_side_path` and
`evaluation.animate_side_by_side` write comparisons. The command line runs
on the card; `main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..config import load_config, parse_yaml
from ..dataset import get_dataset
from ..dataset.view_samplers import get_view_sampler
from ..evaluation.metric_computer import EvaluationCfg, MethodCfg, MetricComputer
from ..training.step_tracker import StepTracker
from . import resolve_device


def main(argv=None, device=None) -> MetricComputer:
    argv = argv if argv is not None else sys.argv[1:]
    experiment, overrides, evaluation = None, [], {}
    for arg in argv:
        if arg.startswith("+experiment="):
            experiment = arg.split("=", 1)[1]
        elif arg.startswith("evaluation."):
            key, _, value = arg.partition("=")
            evaluation[key[len("evaluation."):]] = parse_yaml(value)
        else:
            overrides.append(arg)
    device = resolve_device(device, "compute_metrics")

    cfg = load_config(experiment, overrides)
    methods = [MethodCfg(m["name"], m["key"], Path(m["path"])) for m in evaluation.get("methods") or []]
    if not methods:
        raise SystemExit("pass evaluation.methods=[{name, key, path}, ...]")
    side_by_side = evaluation.get("side_by_side_path")
    eval_cfg = EvaluationCfg(
        methods=methods,
        side_by_side_path=Path(side_by_side) if side_by_side else None,
        animate_side_by_side=bool(evaluation.get("animate_side_by_side", False)),
    )
    view_sampler = get_view_sampler(
        cfg.dataset.view_sampler, "test", False, cfg.dataset.cameras_are_circular, StepTracker(),
    )
    dataset = get_dataset(cfg.dataset, "test", view_sampler)

    computer = MetricComputer(eval_cfg, device=device)
    for example in dataset:
        computer.step({
            "scene": example["scene"],
            "context": {"index": example["context"]["index"]},
            "target": {"index": example["target"]["index"], "image": example["target"]["image"][None]},
        })

    out_path = Path(evaluation.get("output_metrics_path", "outputs/metrics.json"))
    computer.save_scores(out_path)
    with out_path.with_suffix(".mean.json").open("w") as f:
        json.dump(computer.mean_scores(), f, indent=2)
    print(f"scores -> {out_path}")
    return computer


if __name__ == "__main__":
    main()
