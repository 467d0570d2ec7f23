"""Compose qualitative method-comparison figures from rendered frame dirs.

Counterpart of latentsplat_tpu/paper/generate_image_comparison.py: each row
shows the two context views ("Ref.") followed by one rendered target frame
per method; methods typically include a ground-truth directory dumped by
scripts.generate_gt_image_directory. Output is a PNG.

    python -m latentsplat_tpu_torch.paper.generate_image_comparison \\
        methods='[{name: GT, path: outputs/gt}, {name: Ours, path: outputs/test/ours}]' \\
        rows='[{scene: abc, ctx_key: '10_55', index: 30}, ...]' \\
        context_path=outputs/gt \\
        output_path=outputs/figures/comparison.png
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..config import parse_yaml
from ..misc.image_io import save_image
from .common import comparison_grid, load_frame


def build_rows(row_specs: list, methods: list, context_path: Path) -> list:
    rows = []
    for spec in row_specs:
        scene = spec["scene"]
        ctx_key = str(spec["ctx_key"])
        index = int(spec["index"])
        ctx_indices = [int(i) for i in ctx_key.split("_")][:2]
        contexts = ([
            load_frame(context_path, scene, ctx_key, i, kind="context")
            for i in ctx_indices
        ] + [None, None])[:2]
        renders = [
            load_frame(Path(m["path"]), scene, ctx_key, index) for m in methods
        ]
        rows.append(contexts + renders)
    return rows


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    methods = []
    row_specs = []
    context_path = None
    output_path = Path("outputs/figures/comparison.png")
    image_size = 256
    for arg in argv:
        key, _, value = arg.partition("=")
        if key == "methods":
            methods = parse_yaml(value)
        elif key == "rows":
            row_specs = parse_yaml(value)
        elif key == "context_path":
            context_path = Path(value)
        elif key == "output_path":
            output_path = Path(value)
        elif key == "image_size":
            image_size = int(value)
    assert methods and row_specs, (
        "pass methods=[{name, path}, ...] rows=[{scene, ctx_key, index}, ...]"
    )
    if context_path is None:
        context_path = Path(methods[0]["path"])

    rows = build_rows(row_specs, methods, context_path)
    figure = comparison_grid(
        rows, [m["name"] for m in methods], image_size=image_size
    )
    save_image(figure, output_path)
    print(f"figure -> {output_path}")


if __name__ == "__main__":
    main()
