"""Compose the teaser figure: one highlighted example per row, context views
plus the method's rendered target strip.

Counterpart of latentsplat_tpu/paper/generate_teaser.py (a narrow
single-method variant of the comparison grid). PNG output.

    python -m latentsplat_tpu_torch.paper.generate_teaser \\
        method_path=outputs/test/ours context_path=outputs/gt \\
        rows='[{scene: abc, ctx_key: '10_55', indices: [20, 30, 40]}]' \\
        output_path=outputs/figures/teaser.png
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..config import parse_yaml
from ..misc.image_io import save_image
from ..visualization.layout import hcat, resize, vcat
from .common import MARGIN, context_panel, load_frame, _placeholder


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    method_path = None
    context_path = None
    row_specs = []
    output_path = Path("outputs/figures/teaser.png")
    image_size = 192
    for arg in argv:
        key, _, value = arg.partition("=")
        if key == "method_path":
            method_path = Path(value)
        elif key == "context_path":
            context_path = Path(value)
        elif key == "rows":
            row_specs = parse_yaml(value)
        elif key == "output_path":
            output_path = Path(value)
        elif key == "image_size":
            image_size = int(value)
    assert method_path and row_specs, (
        "pass method_path=... rows=[{scene, ctx_key, indices}, ...]"
    )
    if context_path is None:
        context_path = method_path

    figure_rows = []
    for spec in row_specs:
        scene = spec["scene"]
        ctx_key = str(spec["ctx_key"])
        ctx_indices = [int(i) for i in ctx_key.split("_")][:2]
        contexts = [
            load_frame(context_path, scene, ctx_key, i, kind="context")
            for i in ctx_indices
        ]
        panels = [context_panel(contexts, image_size)]
        for index in spec["indices"]:
            img = load_frame(method_path, scene, ctx_key, int(index))
            panels.append(
                resize(img, shape=(image_size, image_size))
                if img is not None
                else _placeholder(image_size)
            )
        figure_rows.append(hcat(*panels, gap=MARGIN))

    figure = vcat(*figure_rows, gap=MARGIN)
    save_image(figure, output_path)
    print(f"figure -> {output_path}")


if __name__ == "__main__":
    main()
