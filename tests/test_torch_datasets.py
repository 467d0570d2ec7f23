"""The port's RE10k and CO3D datasets against the JAX package's, example by
example over the same chunks and trees (built as tests/test_re10k_chunks.py
and tests/test_co3d.py build them): scene order, view indices, cameras,
near and far, and the images bit for bit (the port decodes and resizes in
C with PIL's arithmetic). Then the two dataset scripts against the JAX
scripts, and one CPU `main` step of a tiny model over an RE10k root of the
committed fixture frames."""

import json

import numpy as np
import pytest
from PIL import Image

from latentsplat_tpu.dataset import view_samplers as jax_vs
from latentsplat_tpu.dataset.co3d import DatasetCO3D as JaxDatasetCO3D
from latentsplat_tpu.dataset.re10k import DatasetRE10k as JaxDatasetRE10k
from latentsplat_tpu.dataset.types import DatasetCO3DCfg as JaxCO3DCfg
from latentsplat_tpu.dataset.types import DatasetRE10kCfg as JaxRE10kCfg
from latentsplat_tpu.scripts import generate_co3d_evaluation_index as jax_co3d_index
from latentsplat_tpu.scripts import generate_gt_image_directory as jax_gt_directory
from latentsplat_tpu.training.step_tracker import StepTracker as JaxStepTracker
from latentsplat_tpu_torch.dataset import view_samplers as vs
from latentsplat_tpu_torch.dataset.co3d import DatasetCO3D
from latentsplat_tpu_torch.dataset.jpeg import CorruptJPEGError
from latentsplat_tpu_torch.dataset.re10k import DatasetRE10k
from latentsplat_tpu_torch.dataset.types import DatasetCO3DCfg, DatasetRE10kCfg
from latentsplat_tpu_torch.main import main
from latentsplat_tpu_torch.scripts import generate_co3d_evaluation_index, generate_gt_image_directory
from latentsplat_tpu_torch.training.step_tracker import StepTracker

from tests.test_co3d import _frame, _write_tree
from tests.test_re10k_chunks import _make_chunks
from tests.test_torch_data import TINY
from tests.torch_jpeg_tools import write_re10k_root
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CAMERA_ATOL = 1e-6

SAMPLERS = {
    "bounded": dict(name="bounded", num_context_views=2, num_target_views=2, min_distance_between_context_views=2,
                    max_distance_between_context_views=3, max_distance_to_context_views=1),
    "arbitrary": dict(name="arbitrary", num_context_views=2, num_target_views=2, context_views=[0, 3],
                      target_views=[1, 2]),
    "all": dict(name="all"),
}
SAMPLER_CLASSES = {"bounded": "ViewSamplerBoundedCfg", "arbitrary": "ViewSamplerArbitraryCfg",
                   "all": "ViewSamplerAllCfg", "evaluation": "ViewSamplerEvaluationCfg"}


def _sampler(module, spec: dict, stage: str, overfit: bool, circular: bool, tracker):
    cfg = getattr(module, SAMPLER_CLASSES[spec["name"]])(**spec)
    return module.get_view_sampler(cfg, stage, overfit, circular, tracker)


def _pair(ours_cls, theirs_cls, ours_cfg_cls, theirs_cfg_cls, stage, spec, shard=None, **cfg):
    """The port's and the JAX package's dataset on the same config."""
    datasets = []
    for ds_cls, cfg_cls, module, tracker in ((ours_cls, ours_cfg_cls, vs, StepTracker),
                                             (theirs_cls, theirs_cfg_cls, jax_vs, JaxStepTracker)):
        dcfg = cfg_cls(**cfg)
        sampler = _sampler(module, spec, stage, dcfg.overfit_to_scene is not None, dcfg.cameras_are_circular,
                           tracker())
        ds = ds_cls(dcfg, stage, sampler)
        if shard is not None:
            ds.shard_index, ds.num_shards = shard
        datasets.append(ds)
    return datasets


def assert_examples_equal(ours: list, theirs: list):
    assert [e["scene"] for e in ours] == [e["scene"] for e in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in ("context", "target"):
            va, vb = a[key], b[key]
            assert set(va) == set(vb)
            np.testing.assert_array_equal(va["index"], vb["index"])
            for name in ("extrinsics", "intrinsics", "near", "far"):
                assert va[name].dtype == vb[name].dtype and va[name].shape == vb[name].shape
                np.testing.assert_allclose(va[name], vb[name], rtol=0, atol=CAMERA_ATOL)
            assert va["image"].dtype == vb["image"].dtype == np.float32
            np.testing.assert_array_equal(va["image"], vb["image"])


# -- RE10k ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def re10k_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("re10k")
    _make_chunks(root)
    index = root / "evaluation_index.json"
    index.write_text(json.dumps({"test_scene_0_1": {"context": [1, 5], "target": [2, 3, 4]},
                                 "test_scene_1_0": {"context": [0, 2], "target": [1]},
                                 "test_scene_9_9": None}))
    return root


RE10K_CASES = {
    "train-augment-bounded": dict(stage="train", spec=SAMPLERS["bounded"], augment=True, image_shape=[180, 320]),
    "train-arbitrary": dict(stage="train", spec=SAMPLERS["arbitrary"], augment=False, image_shape=[256, 256]),
    "val-bounded": dict(stage="val", spec=SAMPLERS["bounded"], augment=True, image_shape=[64, 64]),
    "test-all": dict(stage="test", spec=SAMPLERS["all"], image_shape=[64, 64]),
    "test-all-shard-1-of-2": dict(stage="test", spec=SAMPLERS["all"], shard=(1, 2), image_shape=[64, 64]),
    "test-evaluation": dict(stage="test", spec="evaluation", image_shape=[64, 64]),
    "overfit": dict(stage="train", spec=SAMPLERS["arbitrary"], overfit_to_scene="test_scene_0_1",
                    image_shape=[64, 64]),
    "wide-fov-filtered": dict(stage="train", spec=SAMPLERS["arbitrary"], max_fov=30.0, image_shape=[64, 64]),
    "no-baseline-normalization": dict(stage="test", spec=SAMPLERS["arbitrary"], make_baseline_1=False,
                                      image_shape=[64, 64]),
}


@pytest.mark.parametrize("case", sorted(RE10K_CASES))
def test_re10k_matches_jax(re10k_root, case):
    kw = dict(RE10K_CASES[case])
    stage, spec = kw.pop("stage"), kw.pop("spec")
    if spec == "evaluation":
        spec = dict(name="evaluation", index_path=str(re10k_root / "evaluation_index.json"))
    ours, theirs = _pair(DatasetRE10k, JaxDatasetRE10k, DatasetRE10kCfg, JaxRE10kCfg, stage, spec,
                         roots=[str(re10k_root)], **kw)
    assert len(ours) == len(theirs)
    a, b = list(ours), list(theirs)
    if case == "wide-fov-filtered":
        assert a == b == []
    else:
        assert a
    assert_examples_equal(a, b)
    # The same rng state afterwards: the same draws in the same order.
    assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state


def test_re10k_reads_chunks_without_pickle(re10k_root, monkeypatch):
    import torch

    calls = []
    load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: calls.append(k) or load(*a, **k))
    ours, _ = _pair(DatasetRE10k, JaxDatasetRE10k, DatasetRE10kCfg, JaxRE10kCfg, "test", SAMPLERS["all"],
                    roots=[str(re10k_root)], image_shape=[64, 64])
    next(iter(ours))
    assert calls and all(k.get("weights_only") is True for k in calls)


# -- CO3D ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def co3d_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("co3d")
    frames = []
    for i in range(8):   # seq_a: frame 3 is larger (every view goes to the smallest size)
        frames.append(_frame("seq_a", i, 56 if i == 3 else 48, 72 if i == 3 else 64, seed=i))
    for i in range(8):   # seq_b: frame 7 is a reflection, frame 1 in the legacy NDC format
        frames.append(_frame("seq_b", i, 48, 64, seed=10 + i, bad_rotation=i == 7))
    del frames[9]["viewpoint"]["intrinsics_format"]
    for i in range(8):   # seq_c: frame 6's image is missing
        frames.append(_frame("seq_c", i, 48, 64, seed=20 + i))
    split = _write_tree(root, frames)
    (root / "hydrant" / "images" / "seq_c_6.jpg").unlink()
    return root, split


CO3D_CASES = {
    "train-augment-bounded": dict(stage="train", spec=SAMPLERS["bounded"], augment=True),
    "train-planes": dict(stage="train", spec=SAMPLERS["arbitrary"], augment=False, planes=[0.5, 40.0]),
    "val-arbitrary": dict(stage="val", spec=SAMPLERS["arbitrary"]),
    "test-all": dict(stage="test", spec=SAMPLERS["all"]),
    "test-arbitrary-shard-1-of-2": dict(stage="test", spec=SAMPLERS["arbitrary"], shard=(1, 2)),
    "test-bounded-circular": dict(stage="test", spec=dict(SAMPLERS["bounded"], max_distance_to_context_views=2),
                                  cameras_are_circular=True),
    "overfit": dict(stage="train", spec=SAMPLERS["arbitrary"], overfit_to_scene="seq_a"),
    "undersized": dict(stage="test", spec=SAMPLERS["all"], image_shape=[48, 32]),
}


@pytest.mark.parametrize("case", sorted(CO3D_CASES))
def test_co3d_matches_jax(co3d_tree, case):
    root, split = co3d_tree
    kw = dict(CO3D_CASES[case])
    stage, spec = kw.pop("stage"), kw.pop("spec")
    kw.setdefault("image_shape", [32, 32])
    ours, theirs = _pair(DatasetCO3D, JaxDatasetCO3D, DatasetCO3DCfg, JaxCO3DCfg, stage, spec,
                         roots=[str(root)], train_split_json=str(split), eval_split_json=str(split), **kw)
    assert len(ours) == len(theirs)
    a, b = list(ours), list(theirs)
    if case == "undersized":
        assert a == b == []
    else:
        assert a
    assert_examples_equal(a, b)
    assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state


def test_co3d_skips_what_jax_skips(co3d_tree):
    root, split = co3d_tree
    ours, _ = _pair(DatasetCO3D, JaxDatasetCO3D, DatasetCO3DCfg, JaxCO3DCfg, "test", SAMPLERS["all"],
                    roots=[str(root)], train_split_json=str(split), eval_split_json=str(split), image_shape=[32, 32])
    # seq_b holds a reflection and seq_c a missing image: only seq_a is left,
    # its larger frame resized to 48x64 before the crop.
    assert [e["scene"] for e in ours] == ["seq_a"]


def _small_tree(root, damage):
    """Two sequences of 6 frames; `damage(path)` rewrites seq_b's frame 2."""
    frames = [_frame(seq, i, 48, 64, seed=i + 10 * k) for k, seq in enumerate(("seq_a", "seq_b")) for i in range(6)]
    split = _write_tree(root, frames)
    damage(root / "hydrant" / "images" / "seq_b_2.jpg")
    return dict(roots=[str(root)], train_split_json=str(split), eval_split_json=str(split), image_shape=[32, 32])


@pytest.mark.parametrize("damage", ["truncated", "not-jpeg"])
def test_co3d_skips_damaged_frames_as_jax_does(tmp_path, damage):
    # PIL raises OSError on these, and the JAX reader skips the example.
    def rewrite(path):
        path.write_bytes(path.read_bytes()[:300] if damage == "truncated" else b"GIF89a")

    cfg = _small_tree(tmp_path, rewrite)
    ours, theirs = _pair(DatasetCO3D, JaxDatasetCO3D, DatasetCO3DCfg, JaxCO3DCfg, "test", SAMPLERS["all"], **cfg)
    a, b = list(ours), list(theirs)
    assert [e["scene"] for e in a] == ["seq_a"]
    assert_examples_equal(a, b)


def test_co3d_raises_on_a_jpeg_mode_the_decoder_does_not_take(tmp_path):
    # A valid progressive frame is no damage: the port names its marker
    # rather than skip it (PIL decodes it for the JAX reader).
    def progressive(path):
        Image.open(path).convert("RGB").save(path, "JPEG", progressive=True)

    cfg = _small_tree(tmp_path, progressive)
    ours, theirs = _pair(DatasetCO3D, JaxDatasetCO3D, DatasetCO3DCfg, JaxCO3DCfg, "test", SAMPLERS["all"], **cfg)
    assert [e["scene"] for e in theirs] == ["seq_a", "seq_b"]
    with pytest.raises(ValueError, match="SOF2") as raised:
        list(ours)
    assert not isinstance(raised.value, CorruptJPEGError)


# -- the scripts ------------------------------------------------------------------------


def test_co3d_evaluation_index_matches_jax(co3d_tree, tmp_path):
    root, split = co3d_tree
    args = ["+experiment=co3d_hydrant", f"dataset.roots=[{root}]", f"dataset.train_split_json={split}",
            f"dataset.eval_split_json={split}", "dataset.image_shape=[32, 32]", "dataset.view_sampler={name: all}",
            "index_generator.num_target_views=2"]
    path = generate_co3d_evaluation_index.main(args + [f"index_generator.output_path={tmp_path / 'ours'}"])
    jax_co3d_index.main(args + [f"index_generator.output_path={tmp_path / 'theirs'}"])
    theirs = tmp_path / "theirs" / "evaluation_index.json"
    assert path == tmp_path / "ours" / "evaluation_index.json"
    assert json.loads(path.read_text()) and path.read_text() == theirs.read_text()


def test_gt_image_directory_matches_jax(re10k_root, tmp_path):
    sampler = json.dumps(SAMPLERS["arbitrary"])
    args = ["+experiment=re10k", f"dataset.roots=[{re10k_root}]", "dataset.image_shape=[64, 64]",
            f"dataset.view_sampler={sampler}"]
    generate_gt_image_directory.main(args + [f"output_path={tmp_path / 'ours'}"])
    jax_gt_directory.main(args + [f"output_path={tmp_path / 'theirs'}"])
    ours = sorted(p.relative_to(tmp_path / "ours") for p in (tmp_path / "ours").rglob("*.png"))
    theirs = sorted(p.relative_to(tmp_path / "theirs") for p in (tmp_path / "theirs").rglob("*.png"))
    # 4 test scenes, each 2 target (color/) and 2 context (context/) frames.
    assert ours == theirs and len(ours) == 4 * 4
    for rel in ours:
        a = np.asarray(Image.open(tmp_path / "ours" / rel).convert("RGB"))
        b = np.asarray(Image.open(tmp_path / "theirs" / rel).convert("RGB"))
        assert a.shape == (64, 64, 3)
        np.testing.assert_array_equal(a, b)


# -- the program over fixture frames ------------------------------------------------------


def test_main_trains_and_tests_on_re10k_fixture_chunks(tmp_path):
    # Two scenes of 12 frames cycled from the committed 640x360 fixtures; the
    # tiny model at 32x32; train through two worker processes (forkserver,
    # the C library built or loaded in each), test through the thread.
    write_re10k_root(tmp_path / "data", scenes=2, frames=12)
    tiny_sampler = ("{name: bounded, num_target_views: 1, num_context_views: 2, min_distance_between_context_views: 4, "
                    "max_distance_between_context_views: 6, max_distance_to_context_views: 2}")
    dataset = (f"dataset={{name: re10k, roots: [{tmp_path / 'data'}], image_shape: [32, 32], "
               f"view_sampler: {tiny_sampler}}}")
    args = [o for o in TINY if not o.startswith("dataset=")] + [
        dataset, f"output_dir={tmp_path / 'out'}", f"test.output_path={tmp_path / 'test'}", "trainer.max_steps=1",
        "data_loader.train.num_workers=2", "data_loader.val.num_workers=0", "data_loader.test.num_workers=0",
    ]
    run = main(args, device="cpu")
    record = json.loads((run / "local" / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(record["generator/total"])
    assert (run / "checkpoints" / "step_00000001").exists()
    # The test stage: each of the 2 scenes with context 0 and 6 and the 9
    # target views 0..8 (the bounded sampler's largest gaps).
    pngs = sorted((tmp_path / "test" / "latentsplat_tpu").rglob("color/*.png"))
    assert len(pngs) == 2 * 9 and {p.parent.parent.name for p in pngs} == {"0_6"}
