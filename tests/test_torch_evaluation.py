"""The port's evaluation against the JAX package's: SSIM, LPIPS and DISTS on
the same images and weights, the MetricComputer over one PNG directory, the
evaluation index generators (the same index from the same cameras and
seed), the index files, and the scripts that tie them together:
generate_evaluation_index -> compute_metrics, and generate_benchmark_table."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from latentsplat_tpu.evaluation import evaluation_index_generator as jax_index
from latentsplat_tpu.evaluation import metric_computer as jax_mc
from latentsplat_tpu.evaluation import metrics as jax_metrics
from latentsplat_tpu.loss.lpips import LPIPS as JaxLPIPS
from latentsplat_tpu.scripts import compute_metrics as jax_compute_metrics
from latentsplat_tpu.scripts import generate_benchmark_table as jax_benchmark_table
from latentsplat_tpu.scripts import generate_evaluation_index as jax_generate_index
from latentsplat_tpu.visualization.annotation import draw_label as jax_draw_label
from latentsplat_tpu_torch.evaluation import evaluation_index_generator as index_gen
from latentsplat_tpu_torch.evaluation import metric_computer as mc
from latentsplat_tpu_torch.evaluation import metrics
from latentsplat_tpu_torch.evaluation.types import IndexEntry
from latentsplat_tpu_torch.loss.lpips import LPIPS
from latentsplat_tpu_torch.misc.image_io import save_image
from latentsplat_tpu_torch.scripts import compute_metrics, generate_benchmark_table, generate_evaluation_index
from latentsplat_tpu_torch.visualization.annotation import draw_label
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_evaluation import _arc_cameras
from tests.test_torch_data import TINY
from tests.test_torch_training import random_leaves
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def t(x):
    return torch.from_numpy(np.asarray(x))


# -- SSIM -----------------------------------------------------------------------------


def structured_pair():
    yy, xx = np.mgrid[0:48, 0:40] / 48.0
    gt = np.stack([np.sin(6 * xx) * np.cos(4 * yy) * 0.5 + 0.5, xx * yy, np.clip(xx + yy, 0, 1)], axis=-1)
    pred = np.clip(gt * 0.9 + 0.03 * np.sin(20 * xx)[..., None], 0, 1)
    return gt.astype(np.float32), pred.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "structured", "identical"])
def test_ssim_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "structured":
        gt, pred = structured_pair()
    else:
        gt = rng.uniform(size=(2, 3, 40, 56, 3)).astype(np.float32)
        noise = np.asarray([0.02, 0.1, 0.35])[None, :, None, None, None] * rng.normal(size=gt.shape)
        pred = gt if case == "identical" else np.clip(gt + noise, 0, 1).astype(np.float32)
    ours = metrics.compute_ssim(t(gt), t(pred)).numpy()
    theirs = np.asarray(jax_metrics.compute_ssim(jnp.asarray(gt), jnp.asarray(pred)))
    assert ours.shape == theirs.shape == gt.shape[:-3]
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    if case == "identical":
        np.testing.assert_allclose(ours, 1.0, atol=1e-5)


def test_psnr_matches_jax():
    rng = np.random.default_rng(1)
    gt, pred = (rng.uniform(-0.1, 1.1, (3, 16, 16, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        metrics.compute_psnr(t(gt), t(pred)).numpy(), jax_metrics.compute_psnr(jnp.asarray(gt), jnp.asarray(pred)),
        rtol=1e-6,
    )


# -- LPIPS and DISTS ------------------------------------------------------------------


@pytest.fixture(scope="module")
def networks():
    """JAX-initialised DISTS weights (alpha and beta drawn away from their
    constant 0.1) and random LPIPS weights, carried into the port's modules
    by weights.params_from_jax; returns ({name: jax fn}, {name: port fn})."""
    x = jnp.zeros((1, 32, 32, 3))
    dists_params = jax_metrics.DISTSNet().init(jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(2)
    dists_params = jax.tree_util.tree_map(np.asarray, dists_params)
    dists_params["alpha"] = rng.uniform(0.05, 0.2, dists_params["alpha"].shape).astype(np.float32)
    dists_params["beta"] = rng.uniform(0.05, 0.2, dists_params["beta"].shape).astype(np.float32)
    dists = metrics.DISTSNet()
    dists.load_state_dict(params_from_jax(dists_params, dists), strict=True)
    lpips_shapes = jax.eval_shape(lambda: JaxLPIPS().init(jax.random.PRNGKey(0), x, x))
    lpips_params = random_leaves(lpips_shapes["params"], rng)
    lpips = LPIPS()
    lpips.load_state_dict(params_from_jax(lpips_params, lpips), strict=True)
    theirs = {
        "dists": lambda a, b: jax_metrics.DISTSNet().apply({"params": dists_params}, a, b),
        "lpips": lambda a, b: JaxLPIPS().apply({"params": lpips_params}, a, b),
    }
    return theirs, {"dists": dists.eval(), "lpips": lpips.eval()}


def test_dists_matches_jax(networks):
    theirs, ours = networks
    assert ours["dists"].alpha.shape == (1475,)
    rng = np.random.default_rng(3)
    gt = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(size=gt.shape) * np.asarray([0.05, 0.3])[:, None, None, None], 0, 1).astype(np.float32)
    with torch.no_grad():
        got = metrics.compute_dists(t(gt), t(pred), ours["dists"]).numpy()
        same = metrics.compute_dists(t(gt), t(gt), ours["dists"]).numpy()
    want = np.asarray(jax_metrics.compute_dists(jnp.asarray(gt), jnp.asarray(pred), theirs["dists"]))
    assert got.shape == (2,) and (got > 1e-3).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(same, 0.0, atol=1e-5)


def test_lpips_metric_matches_jax(networks):
    theirs, ours = networks
    rng = np.random.default_rng(4)
    gt, pred = (rng.uniform(size=(2, 2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = metrics.compute_lpips(t(gt), t(pred), ours["lpips"]).numpy()
    want = np.asarray(jax_metrics.compute_lpips(jnp.asarray(gt), jnp.asarray(pred), theirs["lpips"]))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


# -- MetricComputer ---------------------------------------------------------------------


def write_method(root, gt, indices, rng, noise, scene="scene_x", context="0_9"):
    for image, index in zip(gt, indices):
        save_image(np.clip(image + rng.normal(size=image.shape) * noise, 0, 1),
                   root / scene / context / "color" / f"{index:0>6}.png")


def test_metric_computer_matches_jax(tmp_path, networks):
    # The PNGs are written once and read by both packages (the port's zlib
    # reader and the JAX package's PIL give the same pixels).
    theirs_fns, ours_fns = networks
    rng = np.random.default_rng(5)
    # Wide enough that no label is wider than its image.
    gt = rng.uniform(size=(3, 32, 224, 3)).astype(np.float32)
    indices = (3, 5, 7)
    write_method(tmp_path / "a", gt, indices, rng, 0.05)
    write_method(tmp_path / "b", gt, indices, rng, 0.2)
    batch = {"scene": "scene_x", "context": {"index": np.asarray([9, 0])},
             "target": {"index": np.asarray(indices), "image": gt[None]}}

    def run(module, side_by_side, **fns):
        methods = [module.MethodCfg("Method A", "a", tmp_path / "a"), module.MethodCfg("Method B", "b", tmp_path / "b")]
        computer = module.MetricComputer(module.EvaluationCfg(methods, side_by_side_path=side_by_side), **fns)
        metrics_ = computer.step(batch, verbose=False)
        computer.save_scores(side_by_side / "scores.json")
        return metrics_, computer

    ours, our_computer = run(mc, tmp_path / "port", lpips_fn=ours_fns["lpips"], dists_fn=ours_fns["dists"],
                             device=CPU)
    theirs, their_computer = run(jax_mc, tmp_path / "jax", lpips_fn=theirs_fns["lpips"],
                                 dists_fn=theirs_fns["dists"])
    assert set(ours) == set(theirs) == {f"{m}_{k}" for m in mc.METRIC_NAMES for k in "ab"}
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=1e-5, err_msg=key)
    our_scores = json.loads((tmp_path / "port" / "scores.json").read_text())
    their_scores = json.loads((tmp_path / "jax" / "scores.json").read_text())
    assert set(our_scores) == set(their_scores)
    for metric, per_scene in their_scores.items():
        for scene, values in per_scene.items():
            assert our_scores[metric][scene].keys() == values.keys()
            for key, value in values.items():
                np.testing.assert_allclose(our_scores[metric][scene][key], value, rtol=0, atol=1e-5)
    assert our_computer.mean_scores().keys() == their_computer.mean_scores().keys()
    assert our_computer._preview_table().splitlines()[:2] == their_computer._preview_table().splitlines()[:2]

    # Side by side: the same files, of the same shape but for the labels'
    # heights (the port draws a bitmap font, the JAX package PIL's DejaVu).
    ours_png = sorted((tmp_path / "port").rglob("0*.png"))
    theirs_png = sorted((tmp_path / "jax").rglob("0*.png"))
    assert [p.relative_to(tmp_path / "port") for p in ours_png] == [p.relative_to(tmp_path / "jax") for p in theirs_png]
    assert len(ours_png) == 3
    def label_rows(draw):   # the row of image labels and the scene's label above it
        row = max(draw(text, font_size=24).shape[0] for text in ("Ground Truth", "Method A", "Method B"))
        return row + draw("Scene scene_x (frames 3 to 7)", font_size=16).shape[0]

    label_gap = label_rows(draw_label) - label_rows(jax_draw_label)
    for a, b in zip(ours_png, theirs_png):
        with Image.open(a) as ours_image, Image.open(b) as theirs_image:
            (w_a, h_a), (w_b, h_b) = ours_image.size, theirs_image.size
        assert w_a == w_b and h_a - h_b == label_gap


def test_metric_computer_skips_a_scene_without_frames(tmp_path):
    computer = mc.MetricComputer(mc.EvaluationCfg([mc.MethodCfg("A", "a", tmp_path)]), device=CPU)
    batch = {"scene": "missing", "context": {"index": np.asarray([0, 4])},
             "target": {"index": np.asarray([2]), "image": np.zeros((1, 1, 16, 16, 3), np.float32)}}
    assert computer.step(batch, verbose=False) is None
    assert computer.scores == {m: {} for m in mc.METRIC_NAMES}


# -- evaluation index -------------------------------------------------------------------


@pytest.mark.parametrize("intra_context, seed", [(True, 0), (True, 1), (False, 2), (False, 3)])
def test_index_generator_matches_jax(intra_context, seed):
    ext, intr = _arc_cameras(24)
    kwargs = dict(
        num_target_views=3 if intra_context else 2, min_context_overlap=0.2, max_context_overlap=1.0,
        min_context_distance=4 if intra_context else 3, max_context_distance=16 if intra_context else 10,
        max_target_distance=6 if intra_context else 8, intra_context=intra_context, output_path="unused",
        num_context_pairs_per_scene=3,
    )
    ours = index_gen.generate_evaluation_index_for_scene(
        index_gen.EvaluationIndexGeneratorCfg(**kwargs), ext, intr, (16, 16), np.random.default_rng(seed))
    theirs = jax_index.generate_evaluation_index_for_scene(
        jax_index.EvaluationIndexGeneratorCfg(**kwargs), ext, intr, (16, 16), np.random.default_rng(seed))
    assert len(ours) == 3
    assert [e.to_dict() for e in ours] == [e.to_dict() for e in theirs]


@pytest.mark.parametrize("intra_context", [True, False])
def test_co3d_index_generator_matches_jax(intra_context):
    kwargs = dict(num_target_views=3, min_context_distance=5, max_context_distance=15,
                  intra_context=intra_context, output_path="unused", num_context_pairs_per_scene=6)
    ours = index_gen.generate_co3d_evaluation_index_for_scene(
        index_gen.CO3DEvaluationIndexGeneratorCfg(**kwargs), 40, np.random.default_rng(4))
    theirs = jax_index.generate_co3d_evaluation_index_for_scene(
        jax_index.CO3DEvaluationIndexGeneratorCfg(**kwargs), 40, np.random.default_rng(4))
    assert ours and [e.to_dict() for e in ours] == [e.to_dict() for e in theirs]


def test_index_files_round_trip_with_jax(tmp_path):
    index = {"scene_a": [IndexEntry((0, 5), (1, 2, 3))], "scene_b": [IndexEntry((2, 9), (4, 6)), IndexEntry((1, 3), (2,))]}
    index_gen.save_index(index, tmp_path / "port")
    jax_index.save_index({k: [jax_index.IndexEntry(e.context, e.target) for e in v] for k, v in index.items()},
                         tmp_path / "jax")
    assert (tmp_path / "port" / "evaluation_index.json").read_text() == (
        tmp_path / "jax" / "evaluation_index.json").read_text()
    loaded = jax_index.load_index(tmp_path / "port" / "evaluation_index.json")
    assert {k: [e.to_dict() for e in v] for k, v in loaded.items()} == {
        k: [e.to_dict() for e in v] for k, v in index.items()}
    (tmp_path / "single.json").write_text(json.dumps({"s1": {"context": [0, 3], "target": [1, 2]}, "s2": None}))
    assert index_gen.load_index(tmp_path / "single.json") == {"s1": [IndexEntry((0, 3), (1, 2))], "s2": None}


# -- the scripts ------------------------------------------------------------------------

INDEX_ARGS = [
    "index_generator.num_target_views=2", "index_generator.min_context_overlap=0.3",
    "index_generator.min_context_distance=4", "index_generator.max_context_distance=8",
    "index_generator.max_target_distance=2",
]
ALL_VIEWS = "dataset.view_sampler={name: all}"


def test_index_then_metrics_scripts_match_jax(tmp_path):
    # The tiny synthetic dataset: both index scripts write the same file;
    # then frames near the ground truth of every indexed view are scored by
    # both compute_metrics scripts.
    ours = generate_evaluation_index.main(
        TINY + [ALL_VIEWS, f"index_generator.output_path={tmp_path / 'port'}"] + INDEX_ARGS, device="cpu")
    jax_generate_index.main(TINY + [ALL_VIEWS, f"index_generator.output_path={tmp_path / 'jax'}"] + INDEX_ARGS)
    index = json.loads(ours.read_text())
    assert index == json.loads((tmp_path / "jax" / "evaluation_index.json").read_text())
    assert len(index) == 6 and all(len(v) == 1 for v in index.values())

    from latentsplat_tpu_torch.config import load_config
    from latentsplat_tpu_torch.dataset import get_dataset
    from latentsplat_tpu_torch.dataset.view_samplers import get_view_sampler
    from latentsplat_tpu_torch.training.step_tracker import StepTracker

    sampler = f"dataset.view_sampler={{name: evaluation, index_path: {ours}}}"
    cfg = load_config(None, TINY + [sampler])
    rng = np.random.default_rng(6)
    dataset = get_dataset(cfg.dataset, "test", get_view_sampler(cfg.dataset.view_sampler, "test", False, False,
                                                                StepTracker()))
    n = 0
    for example in dataset:
        context = "_".join(str(i) for i in np.sort(example["context"]["index"]))
        write_method(tmp_path / "frames", example["target"]["image"], example["target"]["index"], rng, 0.1,
                     example["scene"], context)
        n += 1
    assert n == 6
    args = TINY + [sampler, "evaluation.methods=[{name: Ours, key: ours, path: " + str(tmp_path / "frames") + "}]"]
    computer = compute_metrics.main(args + [f"evaluation.output_metrics_path={tmp_path / 'port.json'}"], device="cpu")
    jax_compute_metrics.main(args + [f"evaluation.output_metrics_path={tmp_path / 'jax.json'}"])
    assert len(computer.scores["psnr"]) == 6
    for name in ("", ".mean"):
        our_scores = json.loads((tmp_path / f"port{name}.json").read_text())
        their_scores = json.loads((tmp_path / f"jax{name}.json").read_text())
        assert jax.tree_util.tree_structure(our_scores) == jax.tree_util.tree_structure(their_scores)
        for a, b in zip(jax.tree_util.tree_leaves(our_scores), jax.tree_util.tree_leaves(their_scores)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_scripts_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the message given where there is no CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        compute_metrics.main(["evaluation.methods=[{name: A, key: a, path: x}]"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        generate_evaluation_index.main([])


def test_benchmark_table_matches_jax(tmp_path, capsys):
    for name, tags, memory in (("a", ("encoder", "decoder", "autoencoder_decoder"), {"cuda:0": 28.07e9}),
                               ("b", ("encoder", "extra_tag"), None)):
        root = tmp_path / name
        root.mkdir()
        rng = np.random.default_rng(len(name) + len(tags))
        (root / "benchmark.json").write_text(json.dumps({t_: rng.uniform(0.01, 0.2, 5).tolist() for t_ in tags}))
        if memory is not None:
            (root / "peak_memory.json").write_text(json.dumps(memory))
    methods = f"methods=[{{name: Ours, path: {tmp_path / 'a'}}}, {{name: Other, path: {tmp_path / 'b'}}}]"
    table = generate_benchmark_table.main([methods, f"output_path={tmp_path / 'port.tex'}"])
    jax_benchmark_table.main([methods, f"output_path={tmp_path / 'jax.tex'}"])
    assert (tmp_path / "port.tex").read_text() == (tmp_path / "jax.tex").read_text() == table + "\n"
    assert "autoencoder decoder (ms)" in table and "28.07" in table and "--" in table
