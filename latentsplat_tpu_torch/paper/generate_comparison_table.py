"""Emit the ranked PSNR/SSIM/LPIPS comparison table.

Counterpart of latentsplat_tpu/paper/generate_comparison_table.py: read the
mean metric scores produced by scripts.compute_metrics and produce a ranked
booktabs LaTeX table (best bold, runner-up underlined).

    python -m latentsplat_tpu_torch.paper.generate_comparison_table \\
        metrics_path=outputs/metrics.mean.json \\
        methods='[{name: latentSplat, key: ours}, {name: pixelSplat, key: pixelsplat}]' \\
        output_path=outputs/table.tex
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..config import parse_yaml
from .table import make_latex_table

METRICS = (
    ("psnr", "PSNR", 1, 2),
    ("ssim", "SSIM", 1, 3),
    ("lpips", "LPIPS", -1, 3),
)


def build_table(mean_scores: dict, methods: list) -> str:
    """mean_scores: {metric: {method_key: value}} (or flat {metric_key: v})."""

    def get(metric: str, key: str):
        if metric in mean_scores and isinstance(mean_scores[metric], dict):
            return mean_scores[metric].get(key)
        return mean_scores.get(f"{metric}_{key}")

    results = {
        m["name"]: [get(metric, m["key"]) for metric, _, _, _ in METRICS]
        for m in methods
    }
    return make_latex_table(
        results,
        [name for _, name, _, _ in METRICS],
        [prec for _, _, _, prec in METRICS],
        [order for _, _, order, _ in METRICS],
    )


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    metrics_path = None
    methods = []
    output_path = Path("outputs/table.tex")
    for arg in argv:
        key, _, value = arg.partition("=")
        if key == "metrics_path":
            metrics_path = Path(value)
        elif key == "methods":
            methods = parse_yaml(value)
        elif key == "output_path":
            output_path = Path(value)
    assert metrics_path and methods, (
        "pass metrics_path=... methods=[{name, key}, ...]"
    )
    mean_scores = json.loads(metrics_path.read_text())
    table = build_table(mean_scores, methods)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(table)
    print(f"table -> {output_path}")


if __name__ == "__main__":
    main()
