"""A LaTeX timing and memory table from test runs' benchmark.json and
peak_memory.json (counterpart of
latentsplat_tpu/scripts/generate_benchmark_table.py):

    python -m latentsplat_tpu_torch.scripts.generate_benchmark_table \\
        'methods=[{name: Ours, path: outputs/test/latentsplat_tpu}]' \\
        output_path=outputs/benchmark_table.tex

One row per method: the mean milliseconds of each timing tag and the
largest peak device memory in GB. Reads JSON only; needs no device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..config import parse_yaml


def load_method(path: Path) -> dict:
    timings = json.loads((path / "benchmark.json").read_text())
    mem_path = path / "peak_memory.json"
    memory = json.loads(mem_path.read_text()) if mem_path.exists() else {}
    return {"timings": timings, "memory": memory}


def main(argv=None) -> str:
    """Writes the table to `output_path`, prints it and returns it."""
    argv = argv if argv is not None else sys.argv[1:]
    methods = []
    output_path = Path("outputs/benchmark_table.tex")
    for arg in argv:
        key, _, value = arg.partition("=")
        if key == "methods":
            methods = parse_yaml(value)
        elif key == "output_path":
            output_path = Path(value)
    if not methods:
        raise SystemExit("pass methods=[{name, path}, ...]")

    loaded, all_tags = [], []
    for m in methods:
        data = load_method(Path(m["path"]))
        loaded.append((m["name"], data))
        all_tags += [tag for tag in data["timings"] if tag not in all_tags]

    header = ("Method & " + " & ".join(f"{tag.replace('_', ' ')} (ms)" for tag in all_tags)
              + " & Peak Mem. (GB) \\\\")
    rows = []
    for name, data in loaded:
        cells = []
        for tag in all_tags:
            times = data["timings"].get(tag)
            cells.append(f"{1e3 * sum(times) / len(times):.1f}" if times else "--")
        peak = max(data["memory"].values(), default=0)
        cells.append(f"{peak / 1e9:.2f}" if peak else "--")
        rows.append(f"{name} & " + " & ".join(cells) + " \\\\")

    table = "\n".join([
        "\\begin{tabular}{l" + "c" * (len(all_tags) + 1) + "}", "\\toprule", header, "\\midrule", *rows,
        "\\bottomrule", "\\end{tabular}",
    ])
    output_path.parent.mkdir(exist_ok=True, parents=True)
    output_path.write_text(table + "\n")
    print(table)
    return table


if __name__ == "__main__":
    main()
