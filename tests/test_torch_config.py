"""The port's config reader against the JAX package's loader and PyYAML,
and the port's independence from JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from latentsplat_tpu.config import PRESET_DIR as JAX_PRESET_DIR
from latentsplat_tpu.config import load_config as jax_load_config
from latentsplat_tpu_torch.config import PRESET_DIR, load_config, parse_yaml

from tests.test_trainer import TINY_OVERRIDES

PRESETS = sorted(Path(JAX_PRESET_DIR).rglob("*.yaml"))
EXPERIMENTS = [None] + sorted(p.stem for p in (Path(JAX_PRESET_DIR) / "experiment").glob("*.yaml"))
SMALL_OVERRIDES = [
    "model.encoder.backbone.model=dino_vits8",
    "model.encoder.d_feature=32",
    "model.encoder.epipolar_transformer.num_layers=1",
    "model.autoencoder.block_out_channels=[16,16,16,16]",
    "model.discriminator=null",
    "model.decoder.backend=dense",
    "dataset.view_sampler={name: evaluation, index_path: assets/evaluation_index/re10k.json}",
]


def test_reads_the_jax_presets():
    assert Path(PRESET_DIR).resolve() == Path(JAX_PRESET_DIR).resolve()
    assert len(PRESETS) == 12


@pytest.mark.parametrize("path", PRESETS, ids=lambda p: p.stem)
def test_yaml_reader_matches_pyyaml(path):
    assert parse_yaml(path.read_text()) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize(
    "text",
    ["5", "-3", "0.5", "1.e-3", "1e-4", "9.0e-6", "200001", "null", "~", "true", "False",
     "dino_vits8", "[16,16,16,16]", "[0.5, 40.0]", "{name: kl, weight: 0.1}",
     "[{name: mse, weight: 10}, {name: lpips, apply_after_step: 50000}]", "'quoted: text'",
     ".inf", "a: 1", ""],
)
def test_yaml_scalars_and_flows_match_pyyaml(text):
    ours, theirs = parse_yaml(text), yaml.safe_load(text)
    assert ours == theirs and type(ours) is type(theirs)


TRAINING_SECTIONS = ("loss", "optimizer", "freeze", "train")
ROOT_SECTIONS = ("mode", "seed", "output_dir", "data_loader", "checkpointing", "trainer", "test", "wandb")


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_model_and_dataset_match_jax(experiment):
    ours = load_config(experiment)
    theirs = jax_load_config(experiment)
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(theirs.model)
    assert dataclasses.asdict(ours.dataset) == dataclasses.asdict(theirs.dataset)
    assert type(ours.dataset).__name__ == type(theirs.dataset).__name__


@pytest.mark.parametrize("experiment", EXPERIMENTS)
@pytest.mark.parametrize("section", TRAINING_SECTIONS)
def test_training_sections_match_jax(experiment, section):
    ours = getattr(load_config(experiment), section)
    theirs = getattr(jax_load_config(experiment), section)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("experiment", EXPERIMENTS)
@pytest.mark.parametrize("section", ROOT_SECTIONS)
def test_root_sections_match_jax(experiment, section):
    ours = getattr(load_config(experiment), section)
    theirs = getattr(jax_load_config(experiment), section)
    if dataclasses.is_dataclass(theirs):
        assert type(ours).__name__ == type(theirs).__name__
        ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    assert ours == theirs and type(ours) is type(theirs)


def test_whole_tree_matches_jax_with_trainer_overrides():
    # The tiny trainer's overrides replace the dataset with the synthetic one
    # and the autoencoder with the identity.
    ours, theirs = load_config(None, TINY_OVERRIDES), jax_load_config(None, TINY_OVERRIDES)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert type(ours.dataset).__name__ == "DatasetSyntheticCfg"
    assert type(ours.model.autoencoder).__name__ == "AutoencoderIdCfg"


def test_re10k_training_config():
    cfg = load_config("re10k")
    combined = cfg.loss.target_combined
    assert [(l.name, l.apply_after_step) for l in combined.nll] == [("l1", 100000), ("lpips", 100000)]
    assert (combined.generator.weight, combined.generator.apply_after_step) == (0.5, 125000)
    assert (combined.discriminator.loss, type(combined.discriminator).__name__) == ("hinge", "LossDiscriminatorCfg")
    assert cfg.optimizer.discriminator.betas == [0.5, 0.9]
    assert cfg.model.discriminator.name == "patch_gan"


def test_overrides_match_jax():
    ours = load_config("re10k", SMALL_OVERRIDES)
    theirs = jax_load_config("re10k", SMALL_OVERRIDES)
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(theirs.model)
    assert dataclasses.asdict(ours.dataset) == dataclasses.asdict(theirs.dataset)
    assert ours.model.encoder.backbone.model == "dino_vits8"
    assert ours.dataset.view_sampler.name == "evaluation"


def test_port_imports_no_jax():
    # Nor PIL: the card machine has none, and the entry point's path runs there.
    modules = (
        "model.latentsplat", "config", "weights", "ops.rasterize.kernels", "main", "training.trainer", "dataset",
        "dataset.synthetic", "dataset.loader", "misc.image_io", "ops.rasterize.api", "model.decoder.splatting",
        "visualization.color_map", "visualization.camera_trajectory", "evaluation.types", "evaluation.metrics",
        "evaluation.metric_computer", "evaluation.evaluation_index_generator", "scripts.compute_metrics",
        "scripts.generate_evaluation_index", "scripts.generate_benchmark_table", "dataset.re10k", "dataset.co3d",
        "dataset.jpeg", "dataset.shims", "host_build", "scripts.generate_co3d_evaluation_index",
        "scripts.generate_gt_image_directory", "training.step", "training.pretrained", "scripts.convert_checkpoint",
        "scripts.render_uncertainty", "scripts.visualize_epipolar_lines", "model.ply_export",
        "model.encoder.visualization", "visualization.validation_in_3d", "visualization.drawing",
        "visualization.colors",
    )
    code = (
        "import sys\n"
        f"import {', '.join('latentsplat_tpu_torch.' + m for m in modules)}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'latentsplat_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
        # The host C library builds and loads at the first decode, never at import.
        "assert latentsplat_tpu_torch.host_build._library is None\n"
    )
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
