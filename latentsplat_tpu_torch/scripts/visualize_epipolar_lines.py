"""Epipolar line segments between context views (counterpart of
latentsplat_tpu/scripts/visualize_epipolar_lines.py):

    python -m latentsplat_tpu_torch.scripts.visualize_epipolar_lines +experiment=re10k \\
        output_path=outputs/epipolar [num_rays=6]

For the first 4 examples of the test stage, `num_rays` pixels of the first
context view (drawn, as in the JAX package, from
`np.random.default_rng(0)`) are cast as rays, projected onto the second
context view's image plane (`geometry.project_rays`) and drawn there as
their clipped segments, beside the first view with the pixels marked, to
<output_path>/<scene>.png. Rays and drawing run on the card;
`main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..dataset import get_dataset
from ..dataset.view_samplers import get_view_sampler
from ..geometry import get_world_rays, project_rays
from ..misc.image_io import save_image
from ..training.step_tracker import StepTracker
from ..visualization.color_map import turbo
from ..visualization.drawing.lines import draw_lines
from ..visualization.drawing.points import draw_points
from ..visualization.layout import hcat
from . import resolve_device


def main(argv=None, device=None) -> Path:
    """Returns the output directory."""
    argv = argv if argv is not None else sys.argv[1:]
    experiment, overrides = None, []
    output_path = Path("outputs/epipolar")
    num_rays = 6
    for arg in argv:
        if arg.startswith("+experiment="):
            experiment = arg.split("=", 1)[1]
        elif arg.startswith("output_path="):
            output_path = Path(arg.split("=", 1)[1])
        elif arg.startswith("num_rays="):
            num_rays = int(arg.split("=", 1)[1])
        else:
            overrides.append(arg)
    device = resolve_device(device, "visualize_epipolar_lines")

    cfg = load_config(experiment, overrides)
    view_sampler = get_view_sampler(
        cfg.dataset.view_sampler, "test", False, cfg.dataset.cameras_are_circular, StepTracker(),
    )
    dataset = get_dataset(cfg.dataset, "test", view_sampler)

    rng = np.random.default_rng(0)
    for i, example in enumerate(dataset):
        if i >= 4:
            break
        context = {k: torch.as_tensor(np.asarray(example["context"][k]), device=device)
                   for k in ("image", "extrinsics", "intrinsics")}
        xy = torch.as_tensor(rng.uniform(0.2, 0.8, size=(num_rays, 2)).astype(np.float32), device=device)
        origins, directions = get_world_rays(xy, context["extrinsics"][0], context["intrinsics"][0])
        projection = project_rays(origins, directions, context["extrinsics"][1], context["intrinsics"][1])
        colors = turbo(np.linspace(0.2, 0.9, num_rays))

        left = draw_points(context["image"][0], xy, colors, radius=3.0)
        valid = projection["overlaps_image"]
        right = draw_lines(
            context["image"][1], projection["xy_min"][valid], projection["xy_max"][valid],
            colors[valid.cpu().numpy()], radius=1.5,
        )
        save_image(hcat(left.cpu().numpy(), right.cpu().numpy()), output_path / f"{example['scene']}.png")
        print(example["scene"])
    return output_path


if __name__ == "__main__":
    main()
