"""Compose the latent-feature modality figure (context + GT + one panel per
rendered modality of a single method).

Counterpart of latentsplat_tpu/paper/generate_feature_image.py: each
row shows the two context views, the ground-truth target, and the method's
per-modality renders (e.g. color / feature PCA / uncertainty — the
modality's `kind` names the subdirectory written by scripts.render_uncertainty
or the test-mode image dump). PNG output.

    python -m latentsplat_tpu_torch.paper.generate_feature_image \\
        method_path=outputs/test/ours gt_path=outputs/gt \\
        modalities='[{name: Color, kind: color}, {name: Features, kind: features}, {name: Uncertainty, kind: uncertainty}]' \\
        rows='[{scene: abc, ctx_key: '10_55', index: 30}]' \\
        output_path=outputs/figures/features.png
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..config import parse_yaml
from ..misc.image_io import save_image
from .common import comparison_grid, load_frame


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    method_path = None
    gt_path = None
    modalities = []
    row_specs = []
    output_path = Path("outputs/figures/features.png")
    image_size = 256
    for arg in argv:
        key, _, value = arg.partition("=")
        if key == "method_path":
            method_path = Path(value)
        elif key == "gt_path":
            gt_path = Path(value)
        elif key == "modalities":
            modalities = parse_yaml(value)
        elif key == "rows":
            row_specs = parse_yaml(value)
        elif key == "output_path":
            output_path = Path(value)
        elif key == "image_size":
            image_size = int(value)
    assert method_path and modalities and row_specs, (
        "pass method_path=... modalities=[{name, kind}, ...] "
        "rows=[{scene, ctx_key, index}, ...]"
    )
    if gt_path is None:
        gt_path = method_path

    rows = []
    for spec in row_specs:
        scene = spec["scene"]
        ctx_key = str(spec["ctx_key"])
        index = int(spec["index"])
        ctx_indices = [int(i) for i in ctx_key.split("_")][:2]
        contexts = ([
            load_frame(gt_path, scene, ctx_key, i, kind="context")
            for i in ctx_indices
        ] + [None, None])[:2]
        gt = load_frame(gt_path, scene, ctx_key, index)
        panels = [
            load_frame(method_path, scene, ctx_key, index, kind=m["kind"])
            for m in modalities
        ]
        rows.append(contexts + [gt] + panels)

    figure = comparison_grid(
        rows,
        ["Target View"] + [m["name"] for m in modalities],
        image_size=image_size,
    )
    save_image(figure, output_path)
    print(f"figure -> {output_path}")


if __name__ == "__main__":
    main()
