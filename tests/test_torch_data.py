"""The port's data pipeline against the JAX package's on the same seeds:
view samplers, the synthetic dataset (augmentation included), the loader
(the cases of tests/test_loader.py on the port's copy) and the trainer's
first batch after `strip_batch` and the data shims."""

import dataclasses
import json
import time
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latentsplat_tpu.config import load_config as jax_load_config
from latentsplat_tpu.dataset import view_samplers as jax_vs
from latentsplat_tpu.dataset.loader import make_loader as jax_make_loader
from latentsplat_tpu.dataset.synthetic import DatasetSynthetic as JaxDatasetSynthetic
from latentsplat_tpu.training.step_tracker import StepTracker as JaxStepTracker
from latentsplat_tpu.training.trainer import Trainer as JaxTrainer
from latentsplat_tpu.training.trainer import strip_batch as jax_strip_batch
from latentsplat_tpu_torch.config import load_config
from latentsplat_tpu_torch.dataset import get_dataset
from latentsplat_tpu_torch.dataset import view_samplers as vs
from latentsplat_tpu_torch.dataset.loader import MultiprocessLoader, batch_iterator, collate, make_loader
from latentsplat_tpu_torch.dataset.shims import draw_flip, flip_example
from latentsplat_tpu_torch.dataset.synthetic import DatasetSynthetic
from latentsplat_tpu_torch.dataset.types import RowShard
from latentsplat_tpu_torch.training.step_tracker import StepTracker
from latentsplat_tpu_torch.training.trainer import Trainer, strip_batch, to_device

from tests.test_loader import CurriculumDataset, DyingDataset, RangeDataset
from tests.test_trainer import TINY_OVERRIDES
from tests.torch_jpeg_tools import write_co3d_tree, write_re10k_root
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# The tiny trainer configuration on one device: the port trains on one card.
TINY = [o for o in TINY_OVERRIDES if not o.startswith("trainer.num_devices")] + ["trainer.num_devices=1"]


def assert_tree_equal(ours, theirs):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            assert_tree_equal(ours[k], theirs[k])
    elif isinstance(theirs, (str, list)):
        assert ours == theirs
    else:
        theirs = np.asarray(theirs)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)


# -- view samplers ----------------------------------------------------------------


def flagship_bounded(cls_module):
    """The re10k preset's bounded sampler (gaps 25 -> 45 over 50,000 steps)."""
    return dataclasses.replace(
        cls_module.ViewSamplerBoundedCfg(), num_target_views=4, min_distance_between_context_views=45,
        max_distance_between_context_views=45, max_distance_to_context_views=45,
        context_gap_warm_up_steps=50000, target_gap_warm_up_steps=50000,
        initial_min_distance_between_context_views=25, initial_max_distance_between_context_views=25,
    )


def sample_both(ours_cfg, theirs_cfg, stage, step=0, circular=False, num_views=150, draws=8):
    tracker, jtracker = StepTracker(), JaxStepTracker()
    tracker.set_step(step)
    jtracker.set_step(step)
    ours = vs.get_view_sampler(ours_cfg, stage, False, circular, tracker)
    theirs = jax_vs.get_view_sampler(theirs_cfg, stage, False, circular, jtracker)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(draws):
        a = ours.sample(f"scene_{i}", num_views, rng)
        b = theirs.sample(f"scene_{i}", num_views, jrng)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.context, y.context)
            np.testing.assert_array_equal(x.target, y.target)
            assert x.context.dtype == y.context.dtype and x.target.dtype == y.target.dtype
    assert (ours.num_context_views, ours.num_target_views) == (theirs.num_context_views, theirs.num_target_views)


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("step", [0, 25000, 60000])
@pytest.mark.parametrize("stage", ["train", "val", "test"])
def test_bounded_sampler_matches_jax(stage, step, circular):
    sample_both(flagship_bounded(vs), flagship_bounded(jax_vs), stage, step, circular)


def test_bounded_sampler_curriculum_moves():
    # At step 0 the context gap is 25, from step 50,000 on it is 45.
    for step, gap in ((0, 25), (60000, 45)):
        tracker = StepTracker()
        tracker.set_step(step)
        sampler = vs.get_view_sampler(flagship_bounded(vs), "train", False, False, tracker)
        (index,) = sampler.sample("s", 150, np.random.default_rng(0))
        assert index.context[1] - index.context[0] == gap


@pytest.mark.parametrize("fixed", [False, True])
def test_arbitrary_sampler_matches_jax(fixed):
    kwargs = {"num_context_views": 3, "num_target_views": 2}
    if fixed:
        kwargs.update(context_views=[1, 5, 9], target_views=[2, 3])
    sample_both(vs.ViewSamplerArbitraryCfg(**kwargs), jax_vs.ViewSamplerArbitraryCfg(**kwargs), "train")


def test_evaluation_sampler_matches_jax():
    path = "assets/evaluation_index/re10k_intra.json"
    ours = vs.get_view_sampler(vs.ViewSamplerEvaluationCfg(index_path=path), "test", False, False, None)
    theirs = jax_vs.get_view_sampler(jax_vs.ViewSamplerEvaluationCfg(index_path=path), "test", False, False, None)
    assert ours.total_samples == theirs.total_samples > 0
    scenes = list(json.loads(open(path).read()))[:50] + ["not_a_scene"]
    rng = np.random.default_rng(0)
    for scene in scenes:
        a, b = ours.sample(scene, 300, rng), theirs.sample(scene, 300, rng)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.context, y.context)
            np.testing.assert_array_equal(x.target, y.target)


def test_all_sampler_matches_jax():
    sample_both(vs.ViewSamplerAllCfg(), jax_vs.ViewSamplerAllCfg(), "test", num_views=17, draws=1)


# -- synthetic dataset --------------------------------------------------------------


def tiny_dataset_cfgs():
    return load_config(None, TINY).dataset, jax_load_config(None, TINY).dataset


@pytest.mark.parametrize("stage", ["train", "val", "test"])
def test_synthetic_examples_match_jax(stage):
    # The first examples, bit for bit; in the train stage the augmentation
    # flips some of them (with the extrinsics reflected).
    cfg, jcfg = tiny_dataset_cfgs()
    ours = get_dataset(cfg, stage, vs.get_view_sampler(cfg.view_sampler, stage, False, False, StepTracker()))
    theirs = JaxDatasetSynthetic(
        jcfg, stage, jax_vs.get_view_sampler(jcfg.view_sampler, stage, False, False, JaxStepTracker())
    )
    n = 0
    for a, b in zip(ours, theirs):
        assert_tree_equal(a, b)
        n += 1
        if n == 4:
            break
    assert n == 4


def test_synthetic_augmentation_flips():
    cfg, _ = tiny_dataset_cfgs()
    plain = DatasetSynthetic(cfg, "val", vs.get_view_sampler(cfg.view_sampler, "val", False, False, None))
    example = next(iter(plain))
    rng = np.random.default_rng(0)
    assert {draw_flip(rng) for _ in range(20)} == {False, True}
    flipped = flip_example(example)
    np.testing.assert_array_equal(flipped["context"]["image"], example["context"]["image"][:, :, ::-1])
    reflect = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    np.testing.assert_array_equal(flipped["target"]["extrinsics"], reflect @ example["target"]["extrinsics"] @ reflect)


@pytest.mark.parametrize("name", ["re10k", "co3d", "synthetic", "unknown"])
def test_get_dataset_builds_each_dataset(name, tmp_path):
    split = write_co3d_tree(tmp_path, sequences=1, frames=2)
    write_re10k_root(tmp_path, scenes=1, frames=2)
    overrides = {"re10k": [f"dataset.roots=[{tmp_path}]"],
                 "co3d": [f"dataset.roots=[{tmp_path}]", f"dataset.train_split_json={split}"],
                 "synthetic": ["dataset={name: synthetic}"], "unknown": []}[name]
    cfg = load_config("co3d_hydrant" if name == "co3d" else "re10k", overrides).dataset
    sampler = vs.get_view_sampler(cfg.view_sampler, "train", False, False, StepTracker())
    if name == "unknown":
        cfg = dataclasses.replace(cfg, name="unknown")
        with pytest.raises(ValueError, match="unknown dataset"):
            get_dataset(cfg, "train", sampler)
        return
    dataset = get_dataset(cfg, "train", sampler)
    assert type(dataset).__name__ == {"re10k": "DatasetRE10k", "co3d": "DatasetCO3D",
                                      "synthetic": "DatasetSynthetic"}[name]
    assert len(dataset) == 1 if name != "synthetic" else len(dataset) == cfg.num_scenes


@pytest.mark.parametrize("stage", ["train", "test"])
def test_make_loader_batches_match_jax(stage):
    cfg, jcfg = tiny_dataset_cfgs()
    ours = make_loader(
        get_dataset(cfg, stage, vs.get_view_sampler(cfg.view_sampler, stage, False, False, None)), 2,
        repeat=stage == "train", drop_last=stage == "train", num_workers=0,
    )
    theirs = jax_make_loader(
        JaxDatasetSynthetic(jcfg, stage, jax_vs.get_view_sampler(jcfg.view_sampler, stage, False, False, None)), 2,
        repeat=stage == "train", drop_last=stage == "train", num_workers=0,
    )
    for _ in range(4 if stage == "train" else 3):   # train: past one pass over the 6 scenes
        assert_tree_equal(next(ours), next(theirs))


# -- the loader's own cases (tests/test_loader.py on the port's copy) ------------


def test_collate_nested():
    batch = collate([
        {"a": np.zeros(3), "nested": {"b": np.ones(2)}, "name": "x"},
        {"a": np.ones(3), "nested": {"b": np.zeros(2)}, "name": "y"},
    ])
    assert batch["a"].shape == (2, 3)
    assert batch["nested"]["b"].shape == (2, 2)
    assert batch["name"] == ["x", "y"]


def test_batch_iterator_drop_last():
    assert len(list(batch_iterator(RangeDataset(10), 4, drop_last=True))) == 2
    batches = list(batch_iterator(RangeDataset(10), 4, drop_last=False))
    assert len(batches) == 3 and batches[-1]["value"].shape[0] == 2


def test_multiprocess_loader_yields_everything():
    # Train stage: every worker walks the whole dataset with its own stream.
    loader = MultiprocessLoader(RangeDataset(16), batch_size=2, num_workers=2, repeat=False, drop_last=True,
                                seed=0, stage="train")
    values = sorted(int(v) for b in loader for v in np.asarray(b["value"]).ravel())
    assert values == sorted(list(range(16)) * 2)
    loader.close()


def test_multiprocess_loader_test_stage_shards():
    loader = MultiprocessLoader(RangeDataset(16), batch_size=2, num_workers=2, repeat=False, drop_last=False,
                                seed=0, stage="test")
    batches = list(loader)
    assert sorted(int(v) for b in batches for v in b["value"].ravel()) == list(range(16))
    assert {int(s) for b in batches for s in b["shard"].ravel()} == {0, 1}
    loader.close()


def test_dead_worker_does_not_hang():
    loader = MultiprocessLoader(DyingDataset(), batch_size=2, num_workers=1, repeat=False, drop_last=True,
                                seed=0, stage="train")
    start = time.monotonic()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        batches = list(loader)
    assert len(batches) == 1
    assert time.monotonic() - start < 60.0
    assert any("died without a sentinel" in str(w.message) for w in caught)
    loader.close()


def test_multiprocess_loader_gives_ranks_rows_of_the_same_global_batches():
    # The workers are taken in turn, so the order is set by their seeds
    # alone: at each step two data-parallel ranks' loaders (2 workers each,
    # 1 row a rank) give the two rows of the one-process loader's batch.
    cfg, _ = tiny_dataset_cfgs()

    def loader(row_shard, batch_size):
        dataset = DatasetSynthetic(cfg, "train", vs.get_view_sampler(cfg.view_sampler, "train", False, False, None))
        dataset.row_shard = row_shard
        return MultiprocessLoader(dataset, batch_size, num_workers=2, repeat=True, seed=0, stage="train")

    loaders = [loader(RowShard(), 2), loader(RowShard(0, 1, 2), 1), loader(RowShard(1, 2, 2), 1)]
    try:
        for _ in range(6):
            whole, *rows = [next(it) for it in loaders]
            for r, row in enumerate(rows):
                for key in ("context", "target"):
                    for name in ("image", "extrinsics", "index"):
                        np.testing.assert_array_equal(row[key][name][0], whole[key][name][r])
    finally:
        for it in loaders:
            it.close()


def test_step_tracker_live_in_workers():
    tracker = StepTracker(step_offset=0)
    loader = MultiprocessLoader(CurriculumDataset(tracker), batch_size=1, num_workers=1, repeat=False,
                                drop_last=True, seed=0, stage="train")
    tracker.set_step(42)
    assert int(next(loader)["step"].ravel()[0]) == 42
    loader.close()


def test_make_loader_dispatches_to_workers():
    it = make_loader(RangeDataset(8), 2, repeat=False, drop_last=True, num_workers=2, seed=0, stage="test")
    assert isinstance(it, MultiprocessLoader)
    assert sum(np.asarray(b["value"]).size for b in it) == 8


# -- the trainer's first batch --------------------------------------------------------


def test_trainer_first_batch_matches_jax(tmp_path):
    overrides = TINY + [f"output_dir={tmp_path}", f"test.output_path={tmp_path}/test"]
    ours = Trainer(load_config(None, overrides), tmp_path / "port", device="cpu")
    theirs = JaxTrainer(jax_load_config(None, overrides), tmp_path / "jax")
    raw = next(ours._loader("train", 1, repeat=False))
    jraw = next(theirs._loader("train", 1, repeat=False))
    assert raw["scene"] == jraw["scene"]
    batch = ours.data_shim(to_device(strip_batch(raw), torch.device("cpu")))
    jbatch = theirs.data_shim(jax.tree_util.tree_map(jnp.asarray, jax_strip_batch(jraw)))
    for key in ("context", "target"):
        assert set(batch[key]) == set(jbatch[key]) == {"extrinsics", "intrinsics", "image", "near", "far"}
        np.testing.assert_array_equal(batch[key]["image"].numpy(), np.asarray(jbatch[key]["image"]))
        np.testing.assert_array_equal(batch[key]["extrinsics"].numpy(), np.asarray(jbatch[key]["extrinsics"]))
        for name in ("near", "far", "intrinsics"):
            np.testing.assert_allclose(batch[key][name].numpy(), np.asarray(jbatch[key][name]), rtol=0, atol=1e-6)
