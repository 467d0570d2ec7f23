"""Emit the ranked timing/memory benchmark table.

Counterpart of latentsplat_tpu/paper/generate_benchmark_table.py: per
method, mean seconds/call of the benchmark.json timing tags (autoencoder
encode, encoder, decoder, autoencoder decode) plus peak device memory (GB)
from peak_memory.json, ranked with make_latex_table. (A plain unranked
variant lives in scripts.generate_benchmark_table.)

    python -m latentsplat_tpu_torch.paper.generate_benchmark_table \\
        methods='[{name: Ours, path: outputs/test/ours}]' \\
        output_path=outputs/benchmark_table.tex
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from ..config import parse_yaml
from .table import make_latex_table

TAGS = (
    ("autoencoder_encoder", "AE Enc. (s)"),
    ("encoder", "Encoding (s)"),
    ("decoder", "Decoding (s)"),
    ("autoencoder_decoder", "AE Dec. (s)"),
)


def load_row(path: Path) -> list:
    row = []
    try:
        benchmark = json.loads((path / "benchmark.json").read_text())
    except FileNotFoundError:
        print(f"Warning: no benchmark.json under {path}")
        benchmark = {}
    for tag, _ in TAGS:
        times = benchmark.get(tag)
        row.append(float(np.mean(times)) if times else None)
    try:
        peak = json.loads((path / "peak_memory.json").read_text())
        if isinstance(peak, dict):
            peak = max(peak.values())
        row.append(float(peak) / 1e9)
    except FileNotFoundError:
        print(f"Warning: no peak_memory.json under {path}")
        row.append(None)
    return row


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    methods = []
    output_path = Path("outputs/benchmark_table.tex")
    for arg in argv:
        key, _, value = arg.partition("=")
        if key == "methods":
            methods = parse_yaml(value)
        elif key == "output_path":
            output_path = Path(value)
    assert methods, "pass methods=[{name, path}, ...]"

    results = {m["name"]: load_row(Path(m["path"])) for m in methods}
    table = make_latex_table(
        results,
        [label for _, label in TAGS] + ["VRAM (GB)"],
        [4, 4, 4, 4, 2],
        [-1, -1, -1, -1, -1],
    )
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(table)
    print(f"table -> {output_path}")


if __name__ == "__main__":
    main()
