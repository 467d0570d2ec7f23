"""Compose the ablation comparison figure (plain method grid, no context
column).

Counterpart of latentsplat_tpu/paper/generate_ablation_image_comparison.py:
each row is one highlighted (scene, target index); each column one ablation
variant's rendered frame, labeled by method name. PNG output.

    python -m latentsplat_tpu_torch.paper.generate_ablation_image_comparison \\
        methods='[{name: Full, path: outputs/test/full}, {name: No GAN, path: outputs/test/no_gan}]' \\
        rows='[{scene: abc, ctx_key: '10_55', index: 30}]' \\
        output_path=outputs/figures/ablation.png
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..config import parse_yaml
from ..misc.image_io import save_image
from .common import plain_grid, load_frame


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    methods = []
    row_specs = []
    output_path = Path("outputs/figures/ablation.png")
    image_size = 256
    for arg in argv:
        key, _, value = arg.partition("=")
        if key == "methods":
            methods = parse_yaml(value)
        elif key == "rows":
            row_specs = parse_yaml(value)
        elif key == "output_path":
            output_path = Path(value)
        elif key == "image_size":
            image_size = int(value)
    assert methods and row_specs, (
        "pass methods=[{name, path}, ...] rows=[{scene, ctx_key, index}, ...]"
    )

    rows = [
        [
            load_frame(
                Path(m["path"]), spec["scene"], str(spec["ctx_key"]),
                int(spec["index"]),
            )
            for m in methods
        ]
        for spec in row_specs
    ]
    figure = plain_grid(rows, [m["name"] for m in methods], image_size=image_size)
    save_image(figure, output_path)
    print(f"figure -> {output_path}")


if __name__ == "__main__":
    main()
