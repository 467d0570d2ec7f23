"""Write a dataset's ground-truth frames in the layout of a method's test
output, so that the captures can be scored and compared like a method
(counterpart of latentsplat_tpu/scripts/generate_gt_image_directory.py):

    python -m latentsplat_tpu_torch.scripts.generate_gt_image_directory +experiment=re10k \\
        output_path=outputs/gt \\
        'dataset.view_sampler={name: evaluation, index_path: assets/evaluation_index/re10k_extra.json}'

Every example of the test stage writes its target frames to
<output_path>/<scene>/<context indices>/color/NNNNNN.png and its context
frames beside them under context/. Runs on the host only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..config import load_config
from ..dataset import get_dataset
from ..dataset.view_samplers import get_view_sampler
from ..misc.image_io import save_image
from ..training.step_tracker import StepTracker


def main(argv=None) -> Path:
    """Returns the output directory."""
    argv = argv if argv is not None else sys.argv[1:]
    experiment, overrides, output_path = None, [], Path("outputs/gt")
    for arg in argv:
        if arg.startswith("+experiment="):
            experiment = arg.split("=", 1)[1]
        elif arg.startswith("output_path="):
            output_path = Path(arg.split("=", 1)[1])
        else:
            overrides.append(arg)

    cfg = load_config(experiment, overrides)
    view_sampler = get_view_sampler(
        cfg.dataset.view_sampler, "test", False, cfg.dataset.cameras_are_circular, StepTracker(),
    )
    for example in get_dataset(cfg.dataset, "test", view_sampler):
        scene = example["scene"]
        ctx_str = "_".join(str(int(i)) for i in np.sort(np.asarray(example["context"]["index"])))
        for key, folder in (("target", "color"), ("context", "context")):
            for image, index in zip(example[key]["image"], example[key]["index"]):
                save_image(image, output_path / scene / ctx_str / folder / f"{int(index):0>6}.png")
        print(scene)
    return output_path


if __name__ == "__main__":
    main()
