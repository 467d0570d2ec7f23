"""Write a CO3D evaluation index: context pairs by frame distance on each
sequence's circular camera path, and their targets (counterpart of
latentsplat_tpu/scripts/generate_co3d_evaluation_index.py):

    python -m latentsplat_tpu_torch.scripts.generate_co3d_evaluation_index +experiment=co3d_hydrant \\
        'dataset.view_sampler={name: all}' index_generator.output_path=outputs/evaluation_index_co3d

Each sequence of the test stage is read once; `index_generator.<field>=value`
overrides the defaults below. The index goes to
<output_path>/evaluation_index.json. Runs on the host only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..config import load_config, parse_yaml
from ..dataset import get_dataset
from ..dataset.view_samplers import get_view_sampler
from ..evaluation.evaluation_index_generator import (
    CO3DEvaluationIndexGeneratorCfg,
    generate_co3d_evaluation_index_for_scene,
    save_index,
)
from ..training.step_tracker import StepTracker

DEFAULTS = dict(
    num_target_views=3,
    min_context_distance=10,
    max_context_distance=30,
    intra_context=True,
    output_path="outputs/evaluation_index_co3d",
    seed=123,
    num_context_pairs_per_scene=1,
)


def main(argv=None) -> Path:
    """Returns the path of the index file."""
    argv = argv if argv is not None else sys.argv[1:]
    experiment, overrides, gen_kwargs = None, [], dict(DEFAULTS)
    for arg in argv:
        if arg.startswith("+experiment="):
            experiment = arg.split("=", 1)[1]
        elif arg.startswith("index_generator."):
            key, _, value = arg.partition("=")
            gen_kwargs[key[len("index_generator."):]] = parse_yaml(value)
        else:
            overrides.append(arg)

    cfg = load_config(experiment, overrides)
    gen_cfg = CO3DEvaluationIndexGeneratorCfg(**{**gen_kwargs, "output_path": Path(gen_kwargs["output_path"])})
    view_sampler = get_view_sampler(
        cfg.dataset.view_sampler, "test", False, cfg.dataset.cameras_are_circular, StepTracker(),
    )
    dataset = get_dataset(cfg.dataset, "test", view_sampler)

    rng = np.random.default_rng(gen_cfg.seed)
    index = {}
    for example in dataset:
        scene = example["scene"]
        if scene in index:
            continue
        num_views = np.asarray(example["target"]["image"]).shape[0]
        index[scene] = generate_co3d_evaluation_index_for_scene(gen_cfg, num_views, rng)
        print(f"{scene}: {len(index[scene])} entries")

    save_index(index, gen_cfg.output_path)
    path = gen_cfg.output_path / "evaluation_index.json"
    print(f"index -> {path}")
    return path


if __name__ == "__main__":
    main()
