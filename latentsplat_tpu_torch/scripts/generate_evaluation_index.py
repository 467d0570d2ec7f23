"""Write an evaluation index, frozen context and target views per scene
(counterpart of latentsplat_tpu/scripts/generate_evaluation_index.py):

    python -m latentsplat_tpu_torch.scripts.generate_evaluation_index +experiment=re10k \\
        'dataset={name: synthetic, num_scenes: 4, num_frames: 48, view_sampler: {name: all}}' \\
        index_generator.output_path=outputs/evaluation_index

Each scene of the test stage is read once with all its frames (the `all`
view sampler), and `generate_evaluation_index_for_scene` picks its context
pairs by ray overlap; `index_generator.<field>=value` overrides the
defaults below. The index goes to <output_path>/evaluation_index.json. The
command line casts the rays on the card; `main(argv, device="cpu")` on the
CPU. The dataset must be one the port has (today the synthetic one).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..config import load_config, parse_yaml
from ..dataset import get_dataset
from ..dataset.view_samplers import get_view_sampler
from ..evaluation.evaluation_index_generator import (
    EvaluationIndexGeneratorCfg,
    generate_evaluation_index_for_scene,
    save_index,
)
from ..training.step_tracker import StepTracker
from . import resolve_device

DEFAULTS = dict(
    num_target_views=3,
    min_context_overlap=0.6,
    max_context_overlap=1.0,
    min_context_distance=45,
    max_context_distance=135,
    max_target_distance=45,
    intra_context=True,
    output_path="outputs/evaluation_index",
    seed=123,
    num_context_pairs_per_scene=1,
)


def main(argv=None, device=None) -> Path:
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
    device = resolve_device(device, "generate_evaluation_index")

    cfg = load_config(experiment, overrides)
    gen_cfg = EvaluationIndexGeneratorCfg(**{**gen_kwargs, "output_path": Path(gen_kwargs["output_path"])})
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
        target = example["target"]
        h, w = np.asarray(target["image"]).shape[-3:-1]
        index[scene] = generate_evaluation_index_for_scene(
            gen_cfg, np.asarray(target["extrinsics"]), np.asarray(target["intrinsics"]), (h, w), rng, device,
        )
        print(f"{scene}: {len(index[scene])} entries")

    save_index(index, gen_cfg.output_path)
    path = gen_cfg.output_path / "evaluation_index.json"
    print(f"index -> {path}")
    return path


if __name__ == "__main__":
    main()
